from .logging import get_logger, set_loglevel  # noqa: F401
from .platform import resolve_device  # noqa: F401
