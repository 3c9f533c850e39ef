"""Weights from the JAX package's Flax variables to the port's ``state_dict``.

``torch_state_from_jax(variables)`` takes an AMD model's
``{"params", "batch_stats"}`` tree (arrays as numpy, or anything
``np.asarray`` reads) and returns the port's ``AMDModel`` state dict:
conv kernels HWIO -> OIHW, BN scale/bias/mean/var -> weight/bias/
running_mean/running_var, Flax module names -> the reference's torch
names. ``rcf_state_from_jax(variables, ema=None)`` does the same for an
RCF model (``backbone2``, ``decode_head`` from JAX's ``flow_head``,
``decode_head2``, ``decode_head3``, and the EMA copies ``backbone2_ema``,
``decode_head2_ema`` from JAX's ``ema_params``/``ema_stats``). The
per-module converters serve the module tests. This module imports no
JAX: the caller hands it plain arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _kernel(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))  # HWIO -> OIHW


def _bn(out: dict, prefix: str, params: dict, stats: dict) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])


def _conv(out: dict, prefix: str, params: dict) -> None:
    out[f"{prefix}.weight"] = _kernel(params["kernel"])
    if "bias" in params:
        out[f"{prefix}.bias"] = _t(params["bias"])


_BLOCK_NAMES = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}


def resnet_state_from_jax(params: dict, stats: dict) -> dict:
    out: dict = {}
    for name, sub in params.items():
        if name == "conv1":
            _conv(out, "conv1", sub)
        elif name == "bn1":
            _bn(out, "bn1", sub, stats[name])
        elif name.startswith("layer"):
            stage, blk = name[len("layer"):].split("_")
            for part, leaf in sub.items():
                key = f"layer{stage}.{blk}.{_BLOCK_NAMES.get(part, part)}"
                if "kernel" in leaf:
                    _conv(out, key, leaf)
                else:
                    _bn(out, key, leaf, stats[name][part])
        else:
            raise KeyError(f"unexpected ResNet parameter {name!r}")
    return out


def fcn_head_state_from_jax(params: dict, stats: dict) -> dict:
    out: dict = {}
    for name, sub in params.items():
        if name == "conv_seg":
            _conv(out, "conv_seg", sub)
            continue
        key = "conv_cat" if name == "conv_cat" else f"convs.{int(name[len('conv'):])}"
        _conv(out, f"{key}.conv", sub["Conv_0"])
        _bn(out, f"{key}.bn", sub["BatchNorm_0"], stats[name]["BatchNorm_0"])
    return out


def flow_head_state_from_jax(params: dict) -> dict:
    """FlowAggregationHead: 3x3 convs -> ``flow_feat_before_agg.{0,2}``, Dense
    [in, out] -> the 1x1 ``Conv1d`` [out, in, 1] ``flow_feat_after_agg.{0,2}``."""
    out: dict = {}
    for i, idx in enumerate((0, 2)):
        _conv(out, f"flow_feat_before_agg.{idx}", params[f"flow_feat_conv{i}"])
        dense = params[f"flow_agg_fc{i}"]
        out[f"flow_feat_after_agg.{idx}.weight"] = _t(np.asarray(dense["kernel"]).T[:, :, None])
        out[f"flow_feat_after_agg.{idx}.bias"] = _t(dense["bias"])
    return out


def pwc_lite_state_from_jax(params: dict) -> dict:
    out: dict = {}
    for name, sub in params.get("pyramid", {}).items():
        lvl, j = name[1:].split("_conv")
        _conv(out, f"feature_pyramid_extractor.convs.{lvl}.{j}.0", sub)
    for name, sub in params.get("estimator", {}).items():
        _conv(out, f"flow_estimators.{name}.0", sub)
    for name, sub in params.items():
        if name.startswith("conv_1x1_"):
            _conv(out, f"conv_1x1.{name[len('conv_1x1_'):]}.0", sub)
    return out


def torch_state_from_jax(variables: dict) -> dict:
    """The port's AMDModel state dict from the JAX AMDModel's variables."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: dict = {}
    parts = (
        ("backbone2", resnet_state_from_jax(params["backbone2"], stats.get("backbone2", {}))),
        ("decode_head2", fcn_head_state_from_jax(params["decode_head2"],
                                                 stats.get("decode_head2", {}))),
        ("flownet", pwc_lite_state_from_jax(params["flownet"])),
    )
    for prefix, sd in parts:
        out.update({f"{prefix}.{k}": v for k, v in sd.items()})
    return out


def _prefixed(prefix: str, sd: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def rcf_state_from_jax(variables: dict, ema: dict | None = None) -> dict:
    """The port's RCFModel state dict from the JAX RCFModel's variables.

    ``ema``: ``{"params": state.ema_params, "batch_stats": state.ema_stats}``
    of a JAX train state, for a model built with ``create_ema``.
    """
    params, stats = variables["params"], variables.get("batch_stats", {})
    out = _prefixed("backbone2", resnet_state_from_jax(params["backbone2"], stats["backbone2"]))
    out.update(_prefixed("decode_head", flow_head_state_from_jax(params["flow_head"])))
    for head in ("decode_head2", "decode_head3"):
        out.update(_prefixed(head, fcn_head_state_from_jax(params[head], stats[head])))
    if ema is not None:
        ep, es = ema["params"], ema["batch_stats"]
        out.update(_prefixed("backbone2_ema",
                             resnet_state_from_jax(ep["backbone2"], es["backbone2"])))
        out.update(_prefixed("decode_head2_ema",
                             fcn_head_state_from_jax(ep["decode_head2"], es["decode_head2"])))
    return out
