from .platform import resolve_device  # noqa: F401
