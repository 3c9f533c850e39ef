"""The port's stage-1 RCF modules against the JAX package, on the CPU.

Regularizers, the common-fate primitives, the affine WLS, the
flow-aggregation head, the FCN head in each input transform (the fused
resize-conv against JAX's and against the port's own plain path), the
ResNet's ``norm_eval``, and the device cache of the resize matrices. Inputs
come from a numpy seed; weights are drawn with numpy in the shapes JAX
reports (``torch_parity.init_variables``) and converted with
``rcf_tpu_torch.convert``. Errors are held against the output's own scale
(``assert_close``), each tolerance beside its measured value.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcf_tpu.losses import common_fate as jcf
from rcf_tpu.losses import regularizers as jreg
from rcf_tpu.nn import FCNHead as JaxFCNHead
from rcf_tpu.nn import FlowAggregationHead as JaxFlowHead
from rcf_tpu.nn import ResNet as JaxResNet
from rcf_tpu.ops import fused_resize_conv as jfrc
from rcf_tpu_torch import convert
from rcf_tpu_torch.losses import common_fate as tcf
from rcf_tpu_torch.losses import regularizers as treg
from rcf_tpu_torch.nn import FCNHead, FlowAggregationHead, ResNet
from rcf_tpu_torch.ops import fused_resize_conv as tfrc
from rcf_tpu_torch.ops import resize as tresize
from rcf_tpu_torch.utils.constants import device_constant
from torch_parity import assert_close, init_variables, to_torch

# Elementwise losses, reductions and their gradients in f32 in both
# frameworks (measured <= 1.2e-6 of the output's scale).
REL = 1e-5
# The affine WLS: moments over H*W pixels, a K x K solve in f32 (measured
# 1.1e-6 linear, 4.6e-6 quadratic, 8.9e-7 with a collapsed mask, 1.1e-5 in
# the head's quadratic case).
REL_AFFINE = 1e-4
# Convolutions, eval and train mode, fused or plain conv0 (measured <= 1e-6).
REL_CONV = 1e-5


def _probs(rng, shape, temp=2.0):
    logits = rng.standard_normal(shape) * temp
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _flow(rng, shape, scale=5.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- regularizers ----------------------------------------------------------

REGULARIZERS = {
    "quirk_log": (lambda m, p: m.quirk_log(p)),
    "entropy_loss": (lambda m, p: m.entropy_loss(p)),
    "sharpen": (lambda m, p: m.sharpen(p, 0.25)),
    "sharpen_loss": (lambda m, p: m.sharpen_loss(p, 0.25)),
    "object_aware_sharpen_loss": (lambda m, p: m.object_aware_sharpen_loss(p, 0.25, 2)),
    "compactness_loss": (lambda m, p: m.compactness_loss(p[..., 1])),
}


@pytest.mark.parametrize("name", sorted(REGULARIZERS))
def test_regularizer_matches_jax(name):
    p = _probs(np.random.default_rng(0), (2, 2, 12, 10, 4))
    fn = REGULARIZERS[name]
    ref = np.asarray(fn(jreg, jnp.asarray(p.reshape(-1, 12, 10, 4) if "compact" in name else p)))
    tp = to_torch(p.reshape(-1, 12, 10, 4) if "compact" in name else p).requires_grad_()
    ours = fn(treg, tp)
    assert_close(ours.detach().numpy(), ref, REL, name)
    # The gradient too, of the same seeded weighting of the output.
    wgt = np.random.default_rng(1).uniform(0.5, 1.5, ref.shape).astype(np.float32)
    gref = jax.grad(lambda x: jnp.sum(fn(jreg, x) * wgt))(
        jnp.asarray(p.reshape(-1, 12, 10, 4) if "compact" in name else p))
    (ours * to_torch(wgt)).sum().backward()
    assert_close(tp.grad.numpy(), np.asarray(gref), REL, f"{name} gradient")


# The mask softmax and quirk_log on bf16 inputs, written step by step as
# jax.nn writes them: the share of outputs that are not bit-equal to JAX's
# bf16 outputs on the same bf16 inputs (logits N(0, 1) over 4 channels).
# Measured: softmax 9.2e-2, quirk_log 8.6e-2; the same function in f32,
# rounded to bf16 at the end, 0.41 and 0.28.
MAX_UNEQUAL_BF16 = 0.15


@pytest.mark.parametrize("name", ["softmax", "quirk_log"])
def test_bf16_softmax_and_quirk_log_round_as_jax(name):
    """The port's bf16 rounding is JAX's, not an f32 computation cast at the end;
    the bf16 entropy loss is bit-equal."""
    from rcf_tpu_torch.models.rcf import softmax

    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 16, 16, 4)), jnp.bfloat16)
    if name == "quirk_log":
        x = jax.nn.softmax(x, axis=-1)
        jfn, tfn = jreg.quirk_log, treg.quirk_log
    else:
        jfn, tfn = (lambda a: jax.nn.softmax(a, axis=-1)), softmax
    ref = np.asarray(jax.jit(jfn)(x).astype(jnp.float32))
    xt = to_torch(np.asarray(x.astype(jnp.float32))).bfloat16()
    ours = tfn(xt)
    assert ours.dtype == torch.bfloat16
    unequal = float(np.mean(ours.float().numpy() != ref))
    unequal_f32 = float(np.mean(tfn(xt.float()).bfloat16().float().numpy() != ref))
    assert unequal <= MAX_UNEQUAL_BF16 < unequal_f32, (unequal, unequal_f32)
    if name == "quirk_log":
        ent = treg.entropy_loss(xt)
        assert ent.dtype == torch.bfloat16
        assert float(ent) == float(jax.jit(jreg.entropy_loss)(x))


def test_object_aware_sharpen_takes_a_device_channel():
    """A tensor object channel (as an elected channel stays on the card) reads
    as the int."""
    p = to_torch(_probs(np.random.default_rng(1), (3, 8, 8, 4)))
    for c in range(4):
        assert torch.equal(treg.object_aware_sharpen_loss(p, 0.25, c),
                           treg.object_aware_sharpen_loss(p, 0.25, torch.tensor(c)))


@pytest.mark.parametrize("pos_th", [-1.0, 0.35])
def test_pseudo_label_loss_matches_jax(pos_th):
    rng = np.random.default_rng(2)
    obj = rng.uniform(0, 1, (2, 2, 12, 12)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 2, 12, 12)).astype(np.float32)
    ref = jreg.pseudo_label_loss(jnp.asarray(obj), jnp.asarray(target), 1.5, 0.5, pos_th)
    ours = treg.pseudo_label_loss(to_torch(obj), to_torch(target), 1.5, 0.5, pos_th)
    assert_close(ours.numpy(), np.asarray(ref), REL)


# -- common fate -----------------------------------------------------------

@pytest.mark.parametrize("opts", [dict(), dict(norm_flow=True), dict(clamp_flow_t=3.0),
                                  dict(clamp_flow_t=20.0, filter_flow_t=2.0)])
def test_norm_and_clamp_flow_matches_jax(opts):
    f = _flow(np.random.default_rng(3), (2, 9, 11, 2))
    ref = jcf.norm_and_clamp_flow(jnp.asarray(f), **opts)
    assert_close(tcf.norm_and_clamp_flow(to_torch(f), **opts).numpy(), np.asarray(ref), REL)


@pytest.mark.parametrize("scale", [10.0, -1.0])
def test_residual_adjustment_matches_jax(scale):
    rng = np.random.default_rng(4)
    res = _flow(rng, (2, 9, 11, 2, 4), 20.0)
    masks = _probs(rng, (2, 9, 11, 4))
    ref = jcf.residual_adjustment(jnp.asarray(res), jnp.asarray(masks), scale=scale)
    ours = tcf.residual_adjustment(to_torch(res), to_torch(masks), scale=scale)
    assert_close(ours.numpy(), np.asarray(ref), REL)


@pytest.mark.parametrize("robust", [False, True])
def test_common_fate_loss_matches_jax(robust):
    rng = np.random.default_rng(5)
    gt, pred = _flow(rng, (2, 9, 11, 2)), _flow(rng, (2, 9, 11, 2))
    ref = jcf.common_fate_loss(jnp.asarray(gt), jnp.asarray(pred), robust)
    ours = tcf.common_fate_loss(to_torch(gt), to_torch(pred), robust)
    assert_close(ours.numpy(), np.asarray(ref), REL)


def _smooth_flow(rng, b, h, w):
    ys, xs = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    coef = rng.standard_normal((b, 1, 1, 2, 3)) * 6
    f = coef[..., 0] * ys[None, ..., None] + coef[..., 1] * xs[None, ..., None] + coef[..., 2]
    return (f + rng.standard_normal((b, h, w, 2)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("case", ["linear", "quadratic", "collapsed"])
def test_demean_affine_flow_matches_jax(case):
    rng = np.random.default_rng(6)
    masks = _probs(rng, (3, 24, 20, 4))
    if case == "collapsed":  # one mask channel all but empty
        masks[..., 3] = 1e-12
        masks /= masks.sum(-1, keepdims=True)
    flow = _smooth_flow(rng, 3, 24, 20)
    quad = case == "quadratic"
    ref = np.asarray(jcf.demean_affine_flow(jnp.asarray(masks), jnp.asarray(flow), quadratic=quad))
    ours = tcf.demean_affine_flow(to_torch(masks), to_torch(flow), quadratic=quad)
    assert ours.dtype == torch.float32
    assert np.isfinite(ref).all()
    assert_close(ours.numpy(), ref, REL_AFFINE, case)


def test_demean_affine_flow_solves_in_f32_from_bf16_masks():
    """bf16 masks are promoted before the moments and the solve, as in JAX."""
    rng = np.random.default_rng(7)
    masks = _probs(rng, (2, 16, 16, 4))
    flow = _smooth_flow(rng, 2, 16, 16)
    ref = np.asarray(jcf.demean_affine_flow(jnp.asarray(masks, jnp.bfloat16), jnp.asarray(flow)))
    ours = tcf.demean_affine_flow(to_torch(masks).bfloat16(), to_torch(flow))
    assert ours.dtype == torch.float32
    assert_close(ours.numpy(), ref, REL_AFFINE)


# -- flow-aggregation head -------------------------------------------------

FLOW_HEAD_MODES = {
    "free_residual": dict(free_residual=True),
    "free_residual_with_affine": dict(free_residual_with_affine=True),
    "affine_quadratic_robust": dict(free_residual_with_affine=True,
                                    free_residual_with_affine_quadratic=True,
                                    outlier_robust_loss=True, residual_adjustment_scale=-1.0),
    "constant_only": dict(),
}


@pytest.mark.parametrize("mode", sorted(FLOW_HEAD_MODES))
def test_flow_head_matches_jax(mode):
    """Losses and every flow of the head, the residual resized 8^2 -> 16^2."""
    rng = np.random.default_rng(8)
    b, c, m = 2, 4, 16
    cfg = dict(mask_layer=c, num_flow_feat_channels=16, mask_size=(m, m), clamp_flow_t=20.0,
               **FLOW_HEAD_MODES[mode])
    masks = _probs(rng, (b, 2, m, m, c))
    fw, bw = _flow(rng, (b, 1, m, m, 2), 8.0), _flow(rng, (b, 1, m, m, 2), 8.0)
    res_fw, res_bw = _flow(rng, (b, 8, 8, 2 * c), 10.0), _flow(rng, (b, 8, 8, 2 * c), 10.0)
    args = [masks, fw, bw, res_fw, res_bw]
    jhead = JaxFlowHead(**cfg)
    v = init_variables(jhead, *map(jnp.asarray, args))
    jlosses, jflows = jhead.apply(v, *map(jnp.asarray, args))
    head = FlowAggregationHead(**cfg)
    head.load_state_dict(convert.flow_head_state_from_jax(v["params"]))
    losses, flows = head(*map(to_torch, args))
    assert set(losses) == set(jlosses) and set(flows) == set(jflows)
    for k in jlosses:
        assert_close(losses[k].detach().numpy(), np.asarray(jlosses[k]), REL, k)
    for k in jflows:
        for ours, ref in zip(flows[k], jflows[k]):
            rel = REL_AFFINE if k in ("affine_flow", "pred_flow") and "affine" in mode else REL
            assert_close(ours.detach().numpy(), np.asarray(ref), rel, k)


# -- FCN head --------------------------------------------------------------

def _feats(rng, n=2):
    """A backbone-like tuple: stage 0 at 16^2, stages 1-3 at 8^2 (OS8)."""
    return [rng.standard_normal((n, s, s, ch)).astype(np.float32)
            for s, ch in ((16, 6), (8, 8), (8, 10), (8, 12))]


FCN_CASES = {
    # the DAVIS mask head: resize_concat of stages 0 and 3, fused conv0
    "resize_concat": dict(input_transform="resize_concat", in_index=[0, 3], in_channels=[6, 12],
                          concat_input=False),
    # three sources, two of them upsampled (each through the fused conv)
    "resize_concat3": dict(input_transform="resize_concat", in_index=[0, 2, 3],
                           in_channels=[6, 10, 12], concat_input=False),
    # the STv2 mask head: input_transform null, one feature
    "single": dict(in_index=3, in_channels=12, concat_input=False),
    # concat_input's conv_cat over the resize_concat input (no fused conv0)
    "concat_input": dict(input_transform="resize_concat", in_index=[0, 3], in_channels=[6, 12],
                         concat_input=True),
    # the residual head: a tuple element, a deferred frame-major concat
    "pair": dict(in_index=-1, in_channels=24, concat_input=False),
}


def _fcn_inputs(case, feats):
    if case == "pair":  # frames 0/1 of a batch of 2 pairs, as models/rcf.py regroups
        f = feats[3].reshape(1, 2, *feats[3].shape[1:])
        return [(f[:, 0], f[:, 1])]
    return feats


@pytest.mark.parametrize("case", sorted(FCN_CASES))
def test_fcn_head_transforms_match_jax(case):
    """Eval and train mode against JAX (whose fused conv0 is on by default),
    and the port's fused conv0 against its own plain path."""
    rng = np.random.default_rng(9)
    feats = _feats(rng)
    inputs = _fcn_inputs(case, feats)
    cfg = dict(num_classes=5, channels=16, num_convs=2, dilation=6, dropout_ratio=0.0,
               **FCN_CASES[case])
    jcfg = {k: v for k, v in cfg.items() if k != "in_channels"}
    jhead = JaxFCNHead(**jcfg)
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    v = init_variables(jhead, jin, train=False)
    sd = convert.fcn_head_state_from_jax(v["params"], v["batch_stats"])
    fast, plain = FCNHead(**cfg), FCNHead(**cfg, fast_resize_concat=False)
    fast.load_state_dict(sd)
    plain.load_state_dict(sd)
    tin = jax.tree_util.tree_map(to_torch, inputs)
    for train in (False, True):
        ref = jhead.apply(v, jin, train=train, mutable=["batch_stats"])[0]
        fast.train(train)
        plain.train(train)
        with torch.no_grad():
            ours, ours_plain = fast(tin), plain(tin)
        assert_close(ours.numpy(), np.asarray(ref), REL_CONV, f"{case} train={train}")
        assert_close(ours.numpy(), ours_plain.numpy(), REL_CONV, f"{case} fused vs plain")


@pytest.mark.parametrize("shape", [(8, 16, 6), (12, 24, 6), (8, 16, 2), (5, 15, 3), (6, 12, 4)])
def test_fused_resize_conv_matches_jax(shape):
    """Per source: the port's fused conv against JAX's, and against resize-then-conv.

    (in size, out size, dilation): scale 2 and 3, dilation a multiple of the
    scale; ``(6, 12, 4)`` is eligible along both axes with another line set.
    """
    h, ht, d = shape
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, h, h + 1, 5)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 5, 7)) * 0.2).astype(np.float32)
    target = (ht, ht * (h + 1) // h) if (ht * (h + 1)) % h == 0 else (ht, 2 * (h + 1))
    ref = jfrc.fused_resize_conv(jnp.asarray(x), jnp.asarray(k), target, d, False)
    kt = to_torch(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    ours = tfrc.fused_resize_conv(to_torch(x), kt, target, d, False)
    assert (ref is None) == (ours is None)
    direct = tfrc.same_conv(tresize.resize_bilinear(to_torch(x), target), kt, d)
    if ours is None:
        return
    assert_close(ours.numpy(), np.asarray(ref), REL_CONV)
    assert_close(ours.numpy(), direct.numpy(), REL_CONV)


def test_fused_resize_conv_declines_where_the_identity_fails():
    x, k = torch.zeros(1, 8, 8, 2), torch.zeros(3, 2, 3, 3)
    assert tfrc.fused_resize_conv(x, k, (16, 16), 3, False) is None   # dilation not a multiple
    assert tfrc.fused_resize_conv(x, k, (12, 12), 6, False) is None   # non-integer scale
    assert tfrc.fused_resize_conv(x, k, (16, 16), 6, True) is None    # align_corners


# -- ResNet ----------------------------------------------------------------

def test_resnet_norm_eval_matches_jax():
    """norm_eval: BN on running statistics in training, and ``train()`` keeps it so."""
    cfg = dict(depth=18, strides=[1, 2, 1, 1], dilations=[1, 1, 2, 4], contract_dilation=True,
               norm_eval=True, norm_cfg={"type": "SyncBN", "requires_grad": True},
               style="pytorch")
    x = np.random.default_rng(11).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jnet = JaxResNet(**cfg)
    v = init_variables(jnet, jnp.asarray(x), train=True)
    ref, new_vars = jnet.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net = ResNet(**cfg)
    net.load_state_dict(convert.resnet_state_from_jax(v["params"], v["batch_stats"]))
    before = {k: t.clone() for k, t in net.state_dict().items()}
    net.train()
    assert net.training and not any(m.training for m in net.modules() if hasattr(m, "running_mean"))
    with torch.no_grad():
        ours = net(to_torch(x))
    for a, b in zip(ours, ref):
        assert_close(a.numpy(), np.asarray(b), REL_CONV)
    for k, t in net.state_dict().items():  # running statistics untouched, as JAX's
        assert torch.equal(t, before[k]), k
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(a, b)), new_vars["batch_stats"], v["batch_stats"]))


# -- resize cache ----------------------------------------------------------

def test_resize_matrices_stay_on_the_device():
    """After the first call a resize makes no new tensor from numpy: the second
    call reuses the cached matrices (the same objects)."""
    x = torch.randn(2, 7, 9, 3)
    tresize.resize_bilinear(x, (13, 5), False)
    made = []
    orig = torch.from_numpy

    def counting(a):
        made.append(a.shape)
        return orig(a)

    torch.from_numpy = counting
    try:
        for _ in range(3):
            y = tresize.resize_bilinear(x, (13, 5), False)
            tresize.resize_bilinear(x.double(), (13, 5), False)
    finally:
        torch.from_numpy = orig
    assert made == []
    info = device_constant.cache_info()
    assert info.hits >= 12
    a = device_constant(tresize._linear_matrix, (7, 13, False), x.device)
    assert a is device_constant(tresize._linear_matrix, (7, 13, False), x.device)
    assert y.shape == (2, 13, 5, 3)
