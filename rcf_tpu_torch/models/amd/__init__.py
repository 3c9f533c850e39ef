from .amd_model import AMDModel, build_amd_model  # noqa: F401
from .pwc_lite import PWCLite  # noqa: F401
