from .unflow import UnFlowLossCfg, unflow_loss  # noqa: F401
