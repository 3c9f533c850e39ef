from .rcf import RCFModel, build_model  # noqa: F401
