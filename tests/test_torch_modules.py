"""The port's modules against the JAX package, on the CPU, from the same weights.

Flax variables are drawn with numpy in the shapes JAX reports, handed to
the port through ``rcf_tpu_torch.convert``, and both frameworks run the
same numpy inputs (JAX jitted). Dropout is 0: the two frameworks
draw different random bits.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rcf_tpu.losses import unflow as junflow
from rcf_tpu.models.amd import build_amd_model as jax_build_amd_model
from rcf_tpu.models.amd.pwc_lite import FlowEstimatorReduce as JaxFlowEstimatorReduce
from rcf_tpu.models.amd.pwc_lite import PWCLite as JaxPWCLite
from rcf_tpu.nn import FCNHead as JaxFCNHead
from rcf_tpu.nn import ResNet as JaxResNet
from rcf_tpu.ops import resize_bilinear as jax_resize_bilinear
from rcf_tpu.ops import resize_nearest as jax_resize_nearest
from rcf_tpu_torch import convert
from rcf_tpu_torch.losses import unflow as tunflow
from rcf_tpu_torch.models.amd import build_amd_model
from rcf_tpu_torch.models.amd.pwc_lite import PWCLite, mask_pool
from rcf_tpu_torch.nn import FCNHead, ResNet
from rcf_tpu_torch.ops import resize_bilinear, resize_nearest
from torch_parity import assert_close, init_variables, to_torch

# f32 convolutions in both frameworks, summed in other orders through up to
# ~50 layers: the error is measured against the output's own scale. Eval
# mode stays within ~2e-6 of it through ResNet-50. Train-mode BN over the
# few samples per channel of a small input amplifies that noise layer by
# layer (measured: 5e-6 after stage 1, 1.4e-4 after stage 4).
REL = 1e-5
REL_TRAIN = 1e-3

AMD_BACKBONE = {"depth": 50, "num_stages": 4, "out_indices": [0, 1, 2, 3],
                "strides": [1, 2, 1, 1], "dilations": [1, 1, 1, 2],
                "contract_dilation": False}


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("out_hw", [(13, 29), (5, 7)])
def test_resize_bilinear_matches_jax(align, out_hw):
    x = np.random.default_rng(0).standard_normal((2, 9, 11, 3)).astype(np.float32)
    ref = _np(jax_resize_bilinear(jnp.asarray(x), out_hw, align_corners=align))
    np.testing.assert_allclose(resize_bilinear(to_torch(x), out_hw, align).numpy(), ref,
                               atol=1e-6)


@pytest.mark.parametrize("out_hw", [(18, 22), (4, 5)])
def test_resize_nearest_matches_jax(out_hw):
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 2)).astype(np.float32)
    ref = _np(jax_resize_nearest(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(resize_nearest(to_torch(x), out_hw).numpy(), ref)


def test_resnet50_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jnet = JaxResNet(**AMD_BACKBONE)
    v = init_variables(jnet, jnp.asarray(x), train=False)
    tnet = ResNet(**AMD_BACKBONE)
    tnet.load_state_dict(convert.resnet_state_from_jax(v["params"], v["batch_stats"]))

    ref_eval = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(v, jnp.asarray(x))
    tnet.eval()
    with torch.no_grad():
        ours_eval = tnet(to_torch(x))
    for a, b in zip(ours_eval, ref_eval):
        assert_close(a.numpy(), _np(b), REL)

    ref_train, new_vars = jax.jit(
        lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tnet.train()
    with torch.no_grad():
        ours_train = tnet(to_torch(x))
    for a, b in zip(ours_train, ref_train):
        assert_close(a.numpy(), _np(b), rel=REL_TRAIN)
    # Running statistics updated as Flax does (biased batch variance).
    new_sd = convert.resnet_state_from_jax(v["params"], new_vars["batch_stats"])
    for k, t in tnet.state_dict().items():
        assert_close(t.numpy(), new_sd[k].numpy(), rel=REL_TRAIN, msg=k)


def test_fcn_head_matches_jax():
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((2, 8, 8, c)).astype(np.float32) for c in (4, 6, 8, 24)]
    cfg = dict(num_classes=5, channels=16, num_convs=2, dilation=6, dropout_ratio=0.0,
               in_index=3, concat_input=False)
    jhead = JaxFCNHead(**cfg)
    jfeats = [jnp.asarray(f) for f in feats]
    v = init_variables(jhead, jfeats, train=False)
    thead = FCNHead(in_channels=24, **cfg)
    thead.load_state_dict(convert.fcn_head_state_from_jax(v["params"], v["batch_stats"]))
    tfeats = [to_torch(f) for f in feats]
    for train in (False, True):
        ref = jhead.apply(v, jfeats, train=train, mutable=["batch_stats"])[0]
        thead.train(train)
        with torch.no_grad():
            ours = thead(tfeats)
        assert_close(ours.numpy(), _np(ref), REL_TRAIN if train else REL)


def test_fcn_head_default_concat_input_raises():
    """JAX's FCNHead defaults to concat_input=True (a conv_cat fusion). The port
    builds it too, so a head made without the key has its ``conv_cat``, as
    JAX's has (tests/test_torch_rcf_modules.py holds it to JAX's). What still
    raises is ``multiple_select``, on which the JAX head fails."""
    assert JaxFCNHead(num_classes=5).concat_input
    assert hasattr(FCNHead(num_classes=5, in_channels=24, in_index=3), "conv_cat")
    assert not hasattr(FCNHead(num_classes=5, in_channels=24, in_index=3, concat_input=False),
                       "conv_cat")
    with pytest.raises(NotImplementedError):
        FCNHead(num_classes=5, in_channels=[8, 24], in_index=[0, 3],
                input_transform="multiple_select")


def test_mask_pool_bf16_matches_jax():
    """PWC-Lite's mask-average pooling in bf16 against JAX's own pooled vectors.

    JAX's bf16 FlowEstimatorReduce runs on numpy weights and inputs; its
    features (the first input of ``predict_flow1``) and pooled vectors (the
    second, cast to bf16) are caught with an interceptor, and the port pools
    the same features under the same mask. JAX casts the mask to bf16 for the
    f32-accumulated product: the port must too. Sound, the bf16 pooled vectors
    are equal (0 over seeds 0-5); an f32 mask in the product moves 8-11% of
    them by one bf16 ulp, 3.7e-3 to 4.0e-3 of the largest.
    """
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 16, 115)).astype(np.float32)
    logits = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jest = JaxFlowEstimatorReduce(mask_layer=5, dtype=jnp.bfloat16)
    v = init_variables(jest, jnp.asarray(x), jnp.asarray(mask))
    caught = []

    def catch(next_fun, args, kwargs, context):
        if context.module.name == "predict_flow1" and context.method_name == "__call__":
            caught.append(np.asarray(args[0].astype(jnp.float32)))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(catch):
        jest.apply(v, jnp.asarray(x), jnp.asarray(mask))
    feat, pooled = caught
    ours = mask_pool(to_torch(feat).bfloat16().permute(0, 3, 1, 2), to_torch(mask))
    assert ours.dtype == torch.float32
    assert_close(ours.bfloat16().float().numpy(), pooled[:, :, 0, :], 1e-3)


def _pwc_inputs(seed=0, b=2, hw=(64, 96), mhw=(8, 12)):
    rng = np.random.default_rng(seed)
    im1, im2 = (rng.random((b, *hw, 3)).astype(np.float32) for _ in range(2))
    logits = rng.standard_normal((2, b, *mhw, 5)).astype(np.float32)
    masks = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return im1, im2, masks[0], masks[1]


def test_pwc_lite_matches_jax():
    inputs = _pwc_inputs()
    jnet = JaxPWCLite(mask_layer=5)
    jin = [jnp.asarray(a) for a in inputs]
    v = init_variables(jnet, *jin)
    ref = jax.jit(jnet.apply)(v, *jin)
    tnet = PWCLite(mask_layer=5)
    tnet.load_state_dict(convert.pwc_lite_state_from_jax(v["params"]))
    with torch.no_grad():
        ours = tnet(*(to_torch(a) for a in inputs))
    assert set(ours) == set(ref)
    for key in ref:
        assert len(ours[key]) == len(ref[key])
        for a, b in zip(ours[key], ref[key]):
            assert_close(a.numpy(), _np(b), REL, msg=key)


def _flow_pyramid(seed=0, b=2, sizes=((64, 96), (32, 48), (16, 24), (8, 12), (4, 8))):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, w, 4)) * 2.5).astype(np.float32) for h, w in sizes]


_CFGS = {
    "amd": junflow.UnFlowLossCfg(alpha=10, w_scales=(1.0, 1.0, 1.0, 1.0, 0.0),
                                 w_sm_scales=(1.0, 0.0, 0.0, 0.0, 0.0)),
    "smooth_ternary": junflow.UnFlowLossCfg(w_ternary=0.5, w_real_smooth=0.1, smooth_2nd=False),
    "smooth2_zeros": junflow.UnFlowLossCfg(w_real_smooth=0.1, smooth_2nd=True, warp_pad="zeros"),
    # The forward-backward flow check for the occlusion masks (the warp with
    # its image gradient), the AMD recipe's loss otherwise.
    "amd_occ_bidirection": junflow.UnFlowLossCfg(alpha=10, occ_from_back=False,
                                                 w_scales=(1.0, 1.0, 1.0, 1.0, 0.0),
                                                 w_sm_scales=(1.0, 0.0, 0.0, 0.0, 0.0)),
}


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_unflow_loss_and_flow_grads_match_jax(name):
    jcfg = _CFGS[name]
    tcfg = tunflow.UnFlowLossCfg(**jcfg.__dict__)
    rng = np.random.default_rng(5)
    im1, im2 = (rng.random((2, 64, 96, 3)).astype(np.float32) for _ in range(2))
    flows = _flow_pyramid()

    def jloss(fl):
        return junflow.unflow_loss(fl, jnp.asarray(im1), jnp.asarray(im2), jcfg)

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(lambda fl: (jloss(fl)[0], jloss(fl)),
                                                     has_aux=True))([jnp.asarray(f) for f in flows])

    tflows = [to_torch(f).requires_grad_(True) for f in flows]
    ours = tunflow.unflow_loss(tflows, to_torch(im1), to_torch(im2), tcfg)
    ours[0].backward()
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(torch.as_tensor(a).detach()), float(b), rtol=1e-5,
                                   atol=1e-7)
    for t, g, w in zip(tflows, ref_grads, jcfg.w_scales):
        if w == 0:  # an unweighted level never enters the graph
            assert t.grad is None and not np.any(_np(g))
        else:
            assert_close(t.grad.numpy(), _np(g), rel=1e-4)


def test_loss_pieces_match_jax():
    rng = np.random.default_rng(2)
    x, y = (rng.random((2, 12, 16, 3)).astype(np.float32) for _ in range(2))
    flow = rng.standard_normal((2, 12, 16, 2)).astype(np.float32)
    jx, jy, jf = jnp.asarray(x), jnp.asarray(y), jnp.asarray(flow)
    tx, ty, tf = to_torch(x), to_torch(y), to_torch(flow)
    pairs = [
        (tunflow.area_resize(tx, (6, 8)), junflow.area_resize(jx, (6, 8))),
        (tunflow.ssim_dist(tx, ty), junflow.ssim_dist(jx, jy)),
        (tunflow.ternary_dist(tx, ty), junflow.ternary_dist(jx, jy)),
        (tunflow.smooth_grad_1st(tf, tx, 10.0), junflow.smooth_grad_1st(jf, jx, 10.0)),
        (tunflow.smooth_grad_2nd(tf, tx, 10.0), junflow.smooth_grad_2nd(jf, jx, 10.0)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6)


def _amd_kwargs(flow_size=(64, 96)):
    return {
        "w_seg": 1.0, "mask_layer": 5, "flow_size": flow_size,
        "backbone2": dict(AMD_BACKBONE, type="ResNet"),
        "decode_head2": {"type": "FCNHead", "in_channels": 2048, "in_index": 3,
                         "channels": 32, "num_convs": 2, "dilation": 6,
                         "dropout_ratio": 0.0, "num_classes": 5, "concat_input": False},
    }


@pytest.mark.parametrize("log_whole", [False, True])
def test_amd_forward_losses_match_jax(log_whole):
    """``log_whole``: the whole-flow loss reported as ``loss_warp_whole``, outside ``loss``."""
    imgs = np.random.default_rng(4).standard_normal((1, 2, 48, 48, 3)).astype(np.float32)
    mk = dict(_amd_kwargs(), log_whole_flow_loss=log_whole)
    jmodel = jax_build_amd_model(mk)
    v = init_variables(jmodel, jnp.asarray(imgs), train=True)
    (jlosses, jprobs), _ = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(imgs))
    jeval = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, method=jmodel.mask_probs))(
        v, jnp.asarray(imgs[:, 0]))

    model = build_amd_model(mk, device="cpu")
    model.load_state_dict(convert.torch_state_from_jax(v))
    with torch.no_grad():
        model.eval()  # before the train-mode forward moves the running statistics
        probs_eval = model.mask_probs(to_torch(imgs[:, 0]))
        model.train()
        losses, probs = model(to_torch(imgs))
    assert set(losses) == set(jlosses)
    assert ("loss_warp_whole" in losses) == log_whole
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)
    assert_close(probs.numpy(), _np(jprobs), rel=REL_TRAIN)
    assert_close(probs_eval.numpy(), _np(jeval), REL)


# The bf16 AMD forward: the port's loss against JAX's bf16 loss, relative.
# Over input seeds 4-11 at this size (2 pairs of 64^2 frames, flow_size
# 64x96), JAX's own bf16 loss differs from its f32 loss by 6.4e-4 RMS (5.3e-5
# to 1.24e-3), and the port's bf16 loss from JAX's bf16 loss by 4.8e-4 RMS
# (3.3e-5 to 8.1e-4; seed 4, used here, reads 8.1e-4 against JAX's 1.0e-4
# bf16-vs-f32 gap on the same input). The limit is under twice that RMS gap.
# The two differ by bf16 noise: eager PyTorch rounds every op's output to
# bf16, XLA on the CPU keeps fused intermediates in f32; and JAX's CPU warp
# (the gather) returns f32 frames where the port's kernel, as the TPU kernel,
# returns bf16 (one more rounding of the warped frames).
# `PYTHONPATH=. python tests/test_torch_modules.py` measures these numbers.
RTOL_BF16_LOSS = 1.2e-3
# The mask probabilities: over the same seeds JAX's bf16 and f32 probs differ
# by up to 2.9e-2, and the port's bf16 probs from JAX's bf16 ones by as much.
ATOL_BF16_PROBS = 5e-2


def _bf16_case(seed, seg_std=0.01):
    """Frames, Flax variables and JAX's AMD model for the bf16 comparison.

    ``seg_std``: the std the classifier ``conv_seg`` is drawn at (its real
    init, normal 0.01), or None to keep ``init_variables``' he-normal.
    """
    imgs = np.random.default_rng(seed).standard_normal((2, 2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build_amd_model(_amd_kwargs(), dtype=jnp.bfloat16)
    v = init_variables(jmodel, jnp.asarray(imgs), train=True)
    if seg_std is not None:
        seg = v["params"]["decode_head2"]["conv_seg"]
        seg["kernel"] = (seg["kernel"] / seg["kernel"].std() * seg_std).astype(np.float32)
    return imgs, v


def _jax_amd_train_forward(dtype):
    """JAX's AMD forward in training mode, jitted: (variables, imgs) -> (losses, probs)."""
    jmodel = jax_build_amd_model(_amd_kwargs(), dtype=dtype)
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"])[0])


def _port_bf16_forward(v, imgs):
    model = build_amd_model(_amd_kwargs(), device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(convert.torch_state_from_jax(v))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        return model(to_torch(imgs))


def test_amd_forward_bf16_matches_jax():
    """The AMD forward in bf16 (training mode) against JAX's ``dtype=jnp.bfloat16`` model.

    The classifier ``conv_seg`` is drawn at its real init scale (normal, 0.01)
    instead of he-normal: with he-normal logits the softmax saturates and bf16
    rounding moves JAX's own probabilities (bf16 vs f32) by 0.35-0.48 over
    seeds 4-11, which leaves nothing to compare.
    """
    imgs, v = _bf16_case(4)
    jlosses, jprobs = _jax_amd_train_forward(jnp.bfloat16)(v, jnp.asarray(imgs))
    losses, probs = _port_bf16_forward(v, imgs)
    assert probs.dtype == torch.bfloat16 and losses["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(losses["loss"]), float(jlosses["loss"]), rtol=RTOL_BF16_LOSS)
    np.testing.assert_allclose(probs.float().numpy(), np.asarray(jprobs, np.float32),
                               atol=ATOL_BF16_PROBS)


def _measure_bf16_gaps(seeds=range(4, 12)):
    """Print the numbers behind RTOL_BF16_LOSS and ATOL_BF16_PROBS."""
    fwd = {dt: _jax_amd_train_forward(dt) for dt in (jnp.float32, jnp.bfloat16)}
    for seg_std in (0.01, None):
        gaps = []
        for seed in seeds:
            imgs, v = _bf16_case(seed, seg_std)
            (lf, pf), (lb, pb) = (fwd[dt](v, jnp.asarray(imgs)) for dt in fwd)
            tl, tp = _port_bf16_forward(v, imgs)
            lf, lb, tl = float(lf["loss"]), float(lb["loss"]), float(tl["loss"])
            pf, pb = np.asarray(pf, np.float32), np.asarray(pb, np.float32)
            gaps.append((abs(lb - lf) / abs(lf), abs(tl - lb) / abs(lb),
                         np.abs(pb - pf).max(), np.abs(tp.float().numpy() - pb).max()))
            print(f"conv_seg {seg_std or 'he-normal'} seed {seed}: loss JAX bf16 vs f32 "
                  f"{gaps[-1][0]:.2e}, port bf16 vs JAX bf16 {gaps[-1][1]:.2e}; probs "
                  f"{gaps[-1][2]:.2e}, {gaps[-1][3]:.2e}", flush=True)
        g = np.array(gaps)
        print(f"conv_seg {seg_std or 'he-normal'}: RMS {np.sqrt((g ** 2).mean(0))}, "
              f"min {g.min(0)}, max {g.max(0)}", flush=True)


def test_amd_yaml_builds_the_same_model_at_full_width():
    """configs/amd/amd.yaml's model_kwargs give both frameworks one parameter set."""
    import yaml

    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs", "amd", "amd.yaml")
    with open(cfg_path) as f:
        mk = yaml.safe_load(f)["model_kwargs"]
    imgs = jnp.zeros((1, 2, 64, 64, 3), jnp.float32)
    jmodel = jax_build_amd_model(mk)
    shapes = jax.eval_shape(
        lambda key: jmodel.init({"params": key, "dropout": key}, imgs, train=True),
        jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda sd: np.zeros(sd.shape, np.float32), shapes)
    model = build_amd_model(mk, device="cpu")
    model.load_state_dict(convert.torch_state_from_jax(zeros))  # strict: same keys, shapes
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(zeros["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _measure_bf16_gaps()
