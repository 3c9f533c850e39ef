from .amd import AMDModel, build_amd_model  # noqa: F401
from .rcf import RCFModel, build_model  # noqa: F401

MODEL_BUILDERS = {"RCFModel": build_model, "AMDModel": build_amd_model}


def build_from_config(cfg, device="cuda", seed: int = 0, dtype=None):
    """The config's ``model_cls`` (``RCFModel`` or ``AMDModel``) from its
    ``model_kwargs``, initialized from ``seed`` on ``device`` in ``dtype``."""
    import torch

    name = cfg.get("model_cls", "RCFModel")
    if name not in MODEL_BUILDERS:
        raise KeyError(f"unknown model_cls {name!r}; known: {sorted(MODEL_BUILDERS)}")
    kwargs = cfg["model_kwargs"]
    kwargs = kwargs.to_dict() if hasattr(kwargs, "to_dict") else dict(kwargs)
    return MODEL_BUILDERS[name](kwargs, device=device, seed=seed,
                                dtype=dtype or torch.float32)
