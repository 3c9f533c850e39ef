from .ncut import ncut_refine, soft_ncut_value  # noqa: F401
