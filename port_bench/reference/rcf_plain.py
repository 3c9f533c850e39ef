"""Plain PyTorch reference of one RCF training step, written from the model's
description (the RCF paper and its stage-1 / stage-2.1 recipes), not from the
program under test: it imports nothing of ``rcf_tpu_torch`` and of the JAX
package.

What one step computes, in float32 (TF32 off; the caller sets the switches):

* a dilated ResNet-50 (``pytorch`` style, stride on the 3x3 conv, output
  stride 8 by ``strides``/``dilations`` with ``contract_dilation``) over the
  frames of every pair, in training mode (batch statistics; running
  statistics moved with momentum 0.1 and the *biased* batch variance);
* the FCN mask head (``resize_concat`` of stages 0 and 3, or stage 3 alone)
  and the FCN residual head over both frames' stage-3 features, each
  ``num_convs`` dilated 3x3 conv-BN-ReLU blocks, channel dropout drawn from
  the step's generator for the mask head first and the residual head second,
  and a 1x1 classifier with bias;
* the flow-aggregation head: a two-conv flow embedding (LeakyReLU 0.1)
  pooled by the spatially normalised masks, two dense layers to one
  constant flow per mask, painted back through the masks; the tanh-bounded
  mask-gated residual; for the SegTrackv2 recipe the closed-form per-mask
  affine flow (weighted least squares on coordinates in [0, 1) with a
  relative ridge of 1e-6, solved here in float64);
* the L1 common-fate loss both ways, the entropy term (the log of the
  recipe is a log-softmax of the probabilities), the compactness term, and
  in stage 2.1 the CRF loss against a target made from the EMA copies in
  eval mode: the object mask at frame size, the frames and mask on the CRF
  grid (uint8 RGB), the mean-field iterations of the exact normalised
  Gaussian filter over ``(x, y, r, g, b)`` features (a fixed count, or to
  the first that leaves the MAP unchanged with ``stable_exit``; a second,
  spatial-only term with ``scomp_smooth``), the MAP resized back;
* Adam with an L2 term in the gradient (betas 0.9/0.999, eps 1e-8, bias
  correction), then the EMA (``ema = m ema + (1 - m) new``) of the backbone
  and mask head, parameters and running statistics.

``precision`` puts the control in the program's place: ``"bf16"`` or
``"fp8"`` rounds every convolution's and dense layer's input, weight and
incoming gradient to bfloat16, or to float8 e4m3 with a per-tensor scale,
and computes the rest in float32.

Tensors are channel-last where the recipe's shapes are given so
(frames [B, 2, H, W, 3], flows [B, 1, H, W, 2]); convolutions run NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BOTTLENECK_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


# ---------------------------------------------------------------------------
# Lower precision for the control.
# ---------------------------------------------------------------------------

def _rounded(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "fp8":
        scale = 448.0 / x.abs().amax().float().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"unknown precision {mode!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _rounded(x, mode)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, ctx.mode), None


# ---------------------------------------------------------------------------
# Parameters: names, shapes and how they are drawn.
# ---------------------------------------------------------------------------

def _conv_spec(name, cout, cin, k, bias=False):
    out = [(f"{name}.weight", (cout, cin, k, k), ("he", cin * k * k))]
    if bias:
        out.append((f"{name}.bias", (cout,), ("zeros",)))
    return out


def _bn_spec(name, c):
    return [(f"{name}.weight", (c,), ("ones",)), (f"{name}.bias", (c,), ("zeros",))]


def _bn_buffers(name, c):
    return [(f"{name}.running_mean", (c,), ("zeros",)), (f"{name}.running_var", (c,), ("ones",))]


def _resnet_layout(cfg: dict):
    """[(prefix, inplanes, planes, stride, dilation, has_downsample)] of every block."""
    depth = int(cfg.get("depth", 50))
    if depth not in BOTTLENECK_BLOCKS:
        raise ValueError(f"the reference has bottleneck depths {sorted(BOTTLENECK_BLOCKS)}")
    strides, dilations = cfg.get("strides", (1, 2, 2, 2)), cfg.get("dilations", (1, 1, 1, 1))
    contract = bool(cfg.get("contract_dilation", False))
    inplanes = int(cfg.get("stem_channels", 64))
    base = int(cfg.get("base_channels", 64))
    blocks = []
    for s, n in enumerate(BOTTLENECK_BLOCKS[depth][:int(cfg.get("num_stages", 4))]):
        planes = base * 2 ** s
        for b in range(n):
            if b == 0:
                d = dilations[s] // 2 if (contract and dilations[s] > 1) else dilations[s]
                ds = strides[s] != 1 or inplanes != planes * 4
                blocks.append((f"layer{s + 1}.{b}", inplanes, planes, strides[s], d, ds))
                inplanes = planes * 4
            else:
                blocks.append((f"layer{s + 1}.{b}", inplanes, planes, 1, dilations[s], False))
    return blocks


def _resnet_specs(prefix: str, cfg: dict):
    if cfg.get("deep_stem") or cfg.get("avg_down"):
        raise ValueError("the reference has the 7x7 stem and plain downsampling only")
    stem = int(cfg.get("stem_channels", 64))
    params = _conv_spec(f"{prefix}.conv1", stem, 3, 7) + _bn_spec(f"{prefix}.bn1", stem)
    buffers = _bn_buffers(f"{prefix}.bn1", stem)
    for name, cin, planes, _, _, ds in _resnet_layout(cfg):
        p = f"{prefix}.{name}"
        for i, (ci, co, k) in enumerate(((cin, planes, 1), (planes, planes, 3),
                                         (planes, planes * 4, 1)), start=1):
            params += _conv_spec(f"{p}.conv{i}", co, ci, k) + _bn_spec(f"{p}.bn{i}", co)
            buffers += _bn_buffers(f"{p}.bn{i}", co)
        if ds:
            params += _conv_spec(f"{p}.downsample.0", planes * 4, cin, 1)
            params += _bn_spec(f"{p}.downsample.1", planes * 4)
            buffers += _bn_buffers(f"{p}.downsample.1", planes * 4)
    return params, buffers


def resnet_channels(cfg: dict) -> list[int]:
    base = int(cfg.get("base_channels", 64))
    return [base * 2 ** s * 4 for s in range(int(cfg.get("num_stages", 4)))]


def _head_in_channels(head: dict, feat_ch: list[int]) -> int:
    index = head.get("in_index", -1)
    if head.get("input_transform") == "resize_concat":
        return sum(feat_ch[i] for i in index)
    return feat_ch[index]


def _fcn_specs(prefix: str, head: dict, cin: int):
    ch, n, k = int(head.get("channels", 256)), int(head.get("num_convs", 2)), 3
    if head.get("concat_input", True):
        raise ValueError("the recipes' heads have concat_input: false")
    params, buffers = [], []
    for i in range(n):
        params += _conv_spec(f"{prefix}.convs.{i}.conv", ch, cin if i == 0 else ch, k)
        params += _bn_spec(f"{prefix}.convs.{i}.bn", ch)
        buffers += _bn_buffers(f"{prefix}.convs.{i}.bn", ch)
    params += [(f"{prefix}.conv_seg.weight", (int(head["num_classes"]), ch, 1, 1), ("normal", 0.01)),
               (f"{prefix}.conv_seg.bias", (int(head["num_classes"]),), ("zeros",))]
    return params, buffers


def specs(model_kwargs: dict):
    """(parameter specs, buffer specs) of the model: [(name, shape, init)], init one of
    ("he", fan_in), ("lecun", fan_in), ("normal", std), ("zeros",), ("ones",)."""
    bb = model_kwargs["backbone2"]
    feat = resnet_channels(bb)
    params, buffers = _resnet_specs("backbone2", bb)
    fh = model_kwargs["decode_head"]
    ch, k = int(fh.get("num_flow_feat_channels", 64)), int(fh.get("flow_feat_before_agg_kernel_size", 3))
    params += [("decode_head.flow_feat_before_agg.0.weight", (ch, 2, k, k), ("he", 2 * k * k)),
               ("decode_head.flow_feat_before_agg.0.bias", (ch,), ("zeros",)),
               ("decode_head.flow_feat_before_agg.2.weight", (ch, ch, k, k), ("he", ch * k * k)),
               ("decode_head.flow_feat_before_agg.2.bias", (ch,), ("zeros",)),
               ("decode_head.flow_feat_after_agg.0.weight", (ch, ch, 1), ("lecun", ch)),
               ("decode_head.flow_feat_after_agg.0.bias", (ch,), ("zeros",)),
               ("decode_head.flow_feat_after_agg.2.weight", (2, ch, 1), ("lecun", ch)),
               ("decode_head.flow_feat_after_agg.2.bias", (2,), ("zeros",))]
    mh = model_kwargs["decode_head2"]
    p, b = _fcn_specs("decode_head2", mh, _head_in_channels(mh, feat))
    params, buffers = params + p, buffers + b
    rh = model_kwargs["decode_head3"]
    if not model_kwargs.get("separate_residual", False):
        raise ValueError("the recipes set separate_residual: true")
    p, b = _fcn_specs("decode_head3", rh, 2 * feat[rh.get("in_index", -1)])
    params, buffers = params + p, buffers + b
    if bb.get("create_ema"):
        own = [s for s in params if s[0].startswith(("backbone2.", "decode_head2."))]
        ema_bufs = [s for s in buffers if s[0].startswith(("backbone2.", "decode_head2."))]
        buffers += [(_ema_name(n), shape, init) for n, shape, init in own + ema_bufs]
    return params, buffers


def _ema_name(name: str) -> str:
    head, rest = name.split(".", 1)
    return f"{head}_ema.{rest}"


# ---------------------------------------------------------------------------
# The forward pass.
# ---------------------------------------------------------------------------

class Net:
    """The model's functions over a dict of tensors (parameters, statistics)."""

    def __init__(self, model_kwargs: dict, precision: str | None = None):
        self.kw = model_kwargs
        self.precision = precision

    def _q(self, x):
        return x if self.precision is None else _Round.apply(x, self.precision)

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return F.conv2d(self._q(x), self._q(w), b, stride, padding, dilation)

    def dense(self, x, w, b):
        return F.linear(self._q(x), self._q(w), b)

    @staticmethod
    def bn(x, t, name, training, stats):
        w, b = t[f"{name}.weight"], t[f"{name}.bias"]
        rm, rv = t[f"{name}.running_mean"], t[f"{name}.running_var"]
        if not training:
            return (x - rm[None, :, None, None]) * torch.rsqrt(rv + BN_EPS)[None, :, None, None] \
                * w[None, :, None, None] + b[None, :, None, None]
        mean = x.mean((0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean((0, 2, 3))
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
        return (x - mean[None, :, None, None]) * torch.rsqrt(var + BN_EPS)[None, :, None, None] \
            * w[None, :, None, None] + b[None, :, None, None]

    def resnet(self, x, t, prefix, training, stats):
        cfg = self.kw["backbone2"]
        x = self.conv(x, t[f"{prefix}.conv1.weight"], stride=2, padding=3)
        x = F.relu(self.bn(x, t, f"{prefix}.bn1", training, stats))
        x = F.max_pool2d(x, 3, 2, 1)
        outs, stage = [], "layer1"
        for name, _, _, stride, d, ds in _resnet_layout(cfg):
            if name.split(".")[0] != stage:
                outs.append(x)
                stage = name.split(".")[0]
            p = f"{prefix}.{name}"
            idn = x
            if ds:
                idn = self.bn(self.conv(x, t[f"{p}.downsample.0.weight"], stride=stride),
                              t, f"{p}.downsample.1", training, stats)
            y = F.relu(self.bn(self.conv(x, t[f"{p}.conv1.weight"]), t, f"{p}.bn1", training, stats))
            y = F.relu(self.bn(self.conv(y, t[f"{p}.conv2.weight"], stride=stride, padding=d,
                                         dilation=d), t, f"{p}.bn2", training, stats))
            y = self.bn(self.conv(y, t[f"{p}.conv3.weight"]), t, f"{p}.bn3", training, stats)
            x = F.relu(y + idn)
        outs.append(x)
        return outs

    def fcn(self, x, t, prefix, head, training, stats, drop=None):
        d = int(head.get("dilation", 1))
        for i in range(int(head.get("num_convs", 2))):
            x = self.conv(x, t[f"{prefix}.convs.{i}.conv.weight"], padding=d, dilation=d)
            x = F.relu(self.bn(x, t, f"{prefix}.convs.{i}.bn", training, stats))
        if drop is not None:
            x = x * drop
        return self.conv(x, t[f"{prefix}.conv_seg.weight"], t[f"{prefix}.conv_seg.bias"])

    def mask_input(self, feats):
        head = self.kw["decode_head2"]
        if head.get("input_transform") == "resize_concat":
            picked = [feats[i] for i in head["in_index"]]
            size = picked[0].shape[-2:]
            return torch.cat([p if p.shape[-2:] == size else
                              F.interpolate(p, size=size, mode="bilinear", align_corners=False)
                              for p in picked], 1)
        return feats[head.get("in_index", -1)]

    def mask_logits(self, frames, t, prefix_bb, prefix_head, training, stats, drop=None):
        """frames NCHW (normalised) -> mask logits NCHW."""
        feats = self.resnet(frames, t, prefix_bb, training, stats)
        return feats, self.fcn(self.mask_input(feats), t, prefix_head, self.kw["decode_head2"],
                               training, stats, drop)


def _dropout_masks(gen, b, ratio_mask, ratio_res, ch_mask, ch_res, device):
    """The heads' channel dropout: the mask head's draw over its 2B rows first,
    then the residual head's over its B rows; kept channels scaled by 1/(1-p)."""
    out = []
    for rows, ratio, ch in ((2 * b, ratio_mask, ch_mask), (b, ratio_res, ch_res)):
        if ratio > 0:
            draw = torch.rand(rows, ch, 1, 1, generator=gen, device=device)
            out.append((draw >= ratio).float() / (1.0 - ratio))
        else:
            out.append(None)
    return out


def softmax_last(x):
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


def resize_hw(x, size):
    """Channel-last [N, H, W, C] bilinear resize (half-pixel centres, edge clamp)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def affine_flow(masks, flow, ridge=1e-6):
    """Per-mask weighted least-squares affine flow about each mask's centroid,
    summed over masks: masks [N, H, W, C], flow [N, H, W, 2] -> [N, H, W, 2]."""
    n, h, w, c = masks.shape
    m = masks.reshape(n, h * w, c).double()
    f = flow.reshape(n, h * w, 2).double()
    ys, xs = torch.meshgrid(torch.arange(h, device=m.device, dtype=torch.float64) / h,
                            torch.arange(w, device=m.device, dtype=torch.float64) / w, indexing="ij")
    om = torch.stack([ys.reshape(-1), xs.reshape(-1)], -1)              # [P, 2]
    wts = m / m.sum(1, keepdim=True)                                     # [N, P, C]
    mu_f = torch.einsum("npc,npk->nck", wts, f)
    mu_o = torch.einsum("npc,pk->nck", wts, om)
    od = om[None, :, None, :] - mu_o[:, None]                            # [N, P, C, 2]
    fd = f[:, :, None, :] - mu_f[:, None]
    a = torch.einsum("npc,npck,npcl->nckl", wts, od, od)                 # [N, C, 2, 2]
    bm = torch.einsum("npc,npck,npcl->nckl", wts, od, fd)                # [N, C, 2(om), 2(f)]
    scale = a.diagonal(dim1=-2, dim2=-1).sum(-1).mean(-1) / 2
    a = a + (ridge * scale)[:, None, None, None] * torch.eye(2, dtype=a.dtype, device=a.device)
    coef = torch.linalg.solve(a, bm)                                     # [N, C, 2(om), 2(f)]
    pred = torch.einsum("npc,npck,nckf->npf", m, od, coef)
    return pred.reshape(n, h, w, 2).float()


def entropy_term(probs):
    qlog = probs - torch.logsumexp(probs, -1, keepdim=True)
    return -(probs * qlog).sum(-1).mean()


def compactness_term(m):
    n, h, w = m.shape
    y = (torch.arange(h, device=m.device, dtype=torch.float32) / h)[None, :, None]
    x = (torch.arange(w, device=m.device, dtype=torch.float32) / w)[None, None, :]
    mass = m.sum((1, 2), keepdim=True)
    yc, xc = (y * m).sum((1, 2), keepdim=True) / mass, (x * m).sum((1, 2), keepdim=True) / mass
    return (((y - yc) ** 2 + (x - xc) ** 2) * m).mean()


def pseudo_label_term(p, target, pos_w, neg_w, pos_th):
    if pos_th != -1.0:
        target = (target > pos_th).float()
    gap = target - p
    return (gap.clamp(min=0) ** 2).mean() * pos_w + (gap.clamp(max=0) ** 2).mean() * neg_w


# ---------------------------------------------------------------------------
# The CRF target.
# ---------------------------------------------------------------------------

def normalized_filter_matrix(feat: torch.Tensor, rows: int = 1024) -> torch.Tensor:
    """[N, N] row-normalised weights exp(-|f_i - f_j|^2 / 2) of one image's
    features [N, D], built from explicit differences in blocks of rows."""
    n = feat.shape[0]
    k = torch.empty(n, n, device=feat.device, dtype=torch.float32)
    for r in range(0, n, rows):
        d = feat[r:r + rows, None, :] - feat[None, :, :]
        k[r:r + rows] = torch.exp(-0.5 * (d * d).sum(-1))
    return k / k.sum(1, keepdim=True)


def crf_map(rgb_u8: torch.Tensor, mask: torch.Tensor, head: dict, xy_scale) -> tuple[torch.Tensor, int]:
    """One image's mean field: uint8 [h, w, 3], soft mask [h, w] -> (the MAP [h, w]
    (0/1), the iterations run). ``stable_exit`` stops at the first iteration that
    leaves the MAP unchanged (``refine_iters`` the cap); ``scomp_smooth`` with
    ``sxy_smooth`` adds a second, spatial-only Gaussian term."""
    srgb, scomp, sxy = float(head.get("srgb", 5.0)), float(head.get("scomp", 5.0)), float(head.get("sxy", 60.0))
    iters, crf_scale = int(head.get("refine_iters", 50)), float(head.get("crf_scale", 0.7))
    scomp_s, sxy_s = float(head.get("scomp_smooth", 0.0)), float(head.get("sxy_smooth", 0.0))
    h, w = mask.shape
    levels = torch.clamp(mask * (255.0 / crf_scale), 0.0, 255.0).floor()
    u = levels / (levels.max() + 1e-8)
    u = torch.clamp(u, 1e-6, 1.0 - 1e-6).reshape(-1)
    du = -torch.log(1.0 - u) + torch.log(u)
    ys, xs = torch.meshgrid(torch.arange(h, device=mask.device, dtype=torch.float32),
                            torch.arange(w, device=mask.device, dtype=torch.float32), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    feat = torch.stack([xs / (sxy * xy_scale[0]), ys / (sxy * xy_scale[1]),
                        *(rgb_u8.reshape(-1, 3).float() / srgb).unbind(-1)], -1)
    kmat = normalized_filter_matrix(feat)
    smooth = None
    if scomp_s > 0 and sxy_s > 0:
        smooth = normalized_filter_matrix(torch.stack([xs / (sxy_s * xy_scale[0]), ys / (sxy_s * xy_scale[1])], -1))
    q = torch.sigmoid(du)
    ran = 0
    for _ in range(iters):
        logit = du + scomp * (2.0 * (kmat @ q) - 1.0)
        if smooth is not None:
            logit = logit + scomp_s * (2.0 * (smooth @ q) - 1.0)
        new = torch.sigmoid(logit)
        stable = bool(head.get("stable_exit")) and bool(((new > 0.5) == (q > 0.5)).all())
        q, ran = new, ran + 1
        if stable:
            break
    del kmat, smooth
    return (q > 0.5).float().reshape(h, w), ran


def crf_refine(frames: torch.Tensor, obj: torch.Tensor, head: dict) -> torch.Tensor:
    """The CRF's answer at frame size: ImageNet-normalised frames [N, H, W, 3] and
    soft object masks [N, H, W] -> each frame's MAP on the CRF grid (uint8 RGB and
    the mask resized there, the spatial widths scaled by the grid ratio), resized
    back to [N, H, W]."""
    n, hh, ww = obj.shape
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    rgb = torch.clamp((frames.float() * std + mean) * 255.0, 0.0, 255.0).floor()
    res = head.get("resolution")
    grid = (hh, ww) if res is None else tuple(res)
    rgb_g = torch.clamp(resize_hw(rgb, grid), 0.0, 255.0).floor()
    obj_g = resize_hw(obj.float()[..., None], grid)[..., 0]
    xy_scale = (grid[1] / ww, grid[0] / hh)
    maps = torch.stack([crf_map(rgb_g[k], obj_g[k], head, xy_scale)[0] for k in range(n)])
    return resize_hw(maps[..., None], (hh, ww))[..., 0]


def crf_target(net: Net, t: dict, imgs: torch.Tensor, channel: int, mask_size, head: dict):
    """Stage 2.1's target [B, 2, h, w] from the EMA copies in eval mode."""
    b, i, hh, ww, _ = imgs.shape
    frames = imgs.reshape(b * i, hh, ww, 3)
    with torch.no_grad():
        _, logits = net.mask_logits(frames.permute(0, 3, 1, 2), t, "backbone2_ema", "decode_head2_ema",
                                    False, None)
        net.last_ema_logits = logits.permute(0, 2, 3, 1)
        probs = softmax_last(net.last_ema_logits)
        obj = resize_hw(probs[..., channel:channel + 1], (hh, ww))[..., 0]
        full = crf_refine(frames, obj, head)
        target = resize_hw(full[..., None], mask_size)[..., 0]
    return target.reshape(b, i, *mask_size)


# ---------------------------------------------------------------------------
# One training step.
# ---------------------------------------------------------------------------

def step_loss(net: Net, t: dict, batch: dict, gen: torch.Generator, stats: dict,
              crf_target_masks=None):
    """The step's loss and its parts: batch imgs [B, 2, H, W, 3] normalised, flows
    [B, 1, H, W, 2]. ``stats`` receives each BN's batch (mean, biased var)."""
    kw = net.kw
    imgs = batch["imgs"]
    b, im_num, hh, ww, _ = imgs.shape
    mh, rh, fh = kw["decode_head2"], kw["decode_head3"], kw["decode_head"]
    drop_m, drop_r = _dropout_masks(gen, b, float(mh.get("dropout_ratio", 0.1)),
                                    float(rh.get("dropout_ratio", 0.1)), int(mh.get("channels", 256)),
                                    int(rh.get("channels", 256)), imgs.device)
    frames = imgs.reshape(b * im_num, hh, ww, 3).permute(0, 3, 1, 2)
    feats, logits = net.mask_logits(frames, t, "backbone2", "decode_head2", True, stats, drop_m)
    mask_size = tuple(kw.get("mask_size", (96, 96)))
    logits = logits.permute(0, 2, 3, 1)
    net.last_logits = logits.detach()
    if kw.get("allow_mask_resize", False):
        logits = resize_hw(logits, mask_size)
    c = int(kw.get("mask_layer", 4))
    h, w = logits.shape[1:3]
    probs = softmax_last(logits.reshape(b, im_num, h, w, c))

    last = feats[rh.get("in_index", -1)]
    pair = last.reshape(b, im_num, *last.shape[1:])
    res = net.fcn(torch.cat([pair[:, 0], pair[:, 1]], 1), t, "decode_head3", rh, True, stats, drop_r)
    res = res.permute(0, 2, 3, 1)
    res_fw, res_bw = res[..., :2 * c], res[..., 2 * c:]

    def flows(x):
        return resize_hw(x[:, 0], mask_size).clamp(-float(fh.get("clamp_flow_t", 20.0)),
                                                   float(fh.get("clamp_flow_t", 20.0)))

    gt = torch.cat([flows(batch["gt_fw_flows"]), flows(batch["gt_bw_flows"])], 0)   # [2B, h, w, 2]
    masks = torch.cat([probs[:, 0], probs[:, 1]], 0)                                 # [2B, h, w, C]
    resid = torch.cat([res_fw, res_bw], 0)
    n = masks.shape[0]
    k = int(fh.get("flow_feat_before_agg_kernel_size", 3))
    e = F.leaky_relu(net.conv(gt.permute(0, 3, 1, 2), t["decode_head.flow_feat_before_agg.0.weight"],
                              t["decode_head.flow_feat_before_agg.0.bias"], padding=k // 2), 0.1)
    e = F.leaky_relu(net.conv(e, t["decode_head.flow_feat_before_agg.2.weight"],
                              t["decode_head.flow_feat_before_agg.2.bias"], padding=k // 2), 0.1)
    feat = e.permute(0, 2, 3, 1).reshape(n, h * w, -1)
    mflat = masks.reshape(n, h * w, c)
    pooled = torch.einsum("npf,npc->ncf", feat, mflat / mflat.sum(1, keepdim=True))
    pooled = F.leaky_relu(net.dense(pooled, t["decode_head.flow_feat_after_agg.0.weight"][:, :, 0],
                                    t["decode_head.flow_feat_after_agg.0.bias"]), 0.1)
    const = net.dense(pooled, t["decode_head.flow_feat_after_agg.2.weight"][:, :, 0],
                      t["decode_head.flow_feat_after_agg.2.bias"])
    pred = torch.einsum("nck,npc->npk", const, mflat).reshape(n, h, w, 2)
    if fh.get("free_residual") or fh.get("free_residual_with_affine"):
        if fh.get("allow_residual_resize", True):
            resid = resize_hw(resid, mask_size)
        r = resid.reshape(n, h, w, 2, c)
        scale, div = float(fh.get("residual_adjustment_scale", 10.0)), float(fh.get("pred_div_coeff", 10.0))
        pred = pred + torch.einsum("nhwkc,nhwc->nhwk", torch.tanh(r / div), masks) * scale
        if fh.get("free_residual_with_affine"):
            pred = pred + affine_flow(masks, gt)
    if fh.get("outlier_robust_loss") or fh.get("norm_flow"):
        raise ValueError("the recipes use the L1 loss on unnormalised flows")
    seg = (gt[:b] - pred[:b]).abs().mean() + (gt[b:] - pred[b:]).abs().mean()
    parts = {"loss_warp_seg": seg}
    loss = seg * float(kw.get("w_seg", 1.0))
    if float(kw.get("w_sharpen", 0)) > 0:
        raise ValueError("the recipes sharpen with w_sharpen 0")
    if float(kw.get("w_entropy", 0)) > 0:
        parts["loss_entropy"] = entropy_term(probs)
        loss = loss + parts["loss_entropy"] * float(kw["w_entropy"])
    if float(kw.get("w_compactness", 0)) != 0:
        channel = int((kw.get("compactness_head") or {}).get("compact_channel", -1))
        if channel < 0:
            raise ValueError("the recipes' compactness uses a fixed channel")
        parts["loss_compactness"] = compactness_term(probs.reshape(n, h, w, c)[..., channel])
        loss = loss + parts["loss_compactness"] * float(kw["w_compactness"])
    if float(kw.get("w_crf", 0)) > 0 and crf_target_masks is not None:
        ch = int(batch.get("object_channel", 0))
        parts["loss_crf"] = pseudo_label_term(probs[..., ch], crf_target_masks,
                                              float(kw.get("crf_pos_weight", 1.0)),
                                              float(kw.get("crf_neg_weight", 1.0)),
                                              float(kw.get("crf_mask_pos_th", -1.0)))
        loss = loss + parts["loss_crf"] * float(kw["w_crf"])
    parts["loss"] = loss
    return parts


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of a step: numpy's SeedSequence of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class ReferenceTrainer:
    """Adam (L2 in the gradient) and the EMA around ``step_loss``, on plain tensors."""

    def __init__(self, model_kwargs: dict, train: dict, params: dict, buffers: dict,
                 precision: str | None = None):
        self.net = Net(model_kwargs, precision)
        self.kw = model_kwargs
        self.lr = float(train["learning_rate"])   # epoch 0 of the poly schedule
        self.wd = float(train.get("weight_decay", 0.0))
        self.p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
        self.buf = {k: v.detach().clone().float() for k, v in buffers.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.has_ema = bool(model_kwargs["backbone2"].get("create_ema", False))
        self.ema_m = float(model_kwargs.get("ema_m", 0.999))

    def tensors(self):
        return {**self.p, **self.buf}

    def step(self, batch: dict, seed: int, step: int) -> dict:
        """One training step; returns the loss parts (floats), the gradient as
        Adam takes it (with the L2 term), the mask head's logits [2B, h, w, C]
        and, in stage 2.1, the EMA copies' logits that the CRF target starts from."""
        target = None
        if float(self.kw.get("w_crf", 0)) > 0 and batch.get("object_channel_set", False):
            target = crf_target(self.net, self.tensors(), batch["imgs"], int(batch.get("object_channel", 0)),
                                tuple(self.kw["mask_size"]), self.kw.get("crf_head") or {})
        gen = torch.Generator(device=batch["imgs"].device)
        gen.manual_seed(step_seed(seed, step))
        stats: dict = {}
        parts = step_loss(self.net, self.tensors(), batch, gen, stats, target)
        names = list(self.p)
        grads = torch.autograd.grad(parts["loss"], [self.p[k] for k in names], allow_unused=True)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        seen = {}
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = self.p[k]
                g = torch.zeros_like(p) if g is None else g
                g = g + self.wd * p
                seen[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = self.m[k] / (1 - b1 ** self.t)
                vhat = self.v[k] / (1 - b2 ** self.t)
                p.sub_(self.lr * mhat / (vhat.sqrt() + eps))
            for name, (mean, var) in stats.items():
                self.buf[f"{name}.running_mean"].mul_(1 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                self.buf[f"{name}.running_var"].mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            if self.has_ema:
                for k in list(self.buf):
                    if "_ema." in k:
                        src = k.replace("_ema.", ".", 1)
                        new = self.p[src] if src in self.p else self.buf[src]
                        self.buf[k].mul_(self.ema_m).add_(new, alpha=1 - self.ema_m)
        return {"losses": {k: float(v.detach()) for k, v in parts.items()}, "grads": seen,
                "logits": self.net.last_logits, "ema_logits": None if target is None else self.net.last_ema_logits}


# ---------------------------------------------------------------------------
# The model FLOPs of a step, counted over this reference.
# ---------------------------------------------------------------------------
#
# ``torch.utils.flop_counter.FlopCounterMode`` over the reference on the meta
# device (shapes only): the trained forward and its backward (gradients of the
# parameters only), and in stage 2.1 the EMA copies' eval forward of the CRF
# target once. Convolutions and matrix products count (2 per multiply-add);
# the mean field does not (its bound is the exponentials, which
# ``kernels.crf_filter_roofline_pct`` reads). The DAVIS mask head's upsampled
# source is counted at its own resolution: a dilation-d conv of a bilinear
# s-times upsample equals the upsample of a dilation-d/s conv at the source but
# on a few edge lines, so no implementation needs more than this count and the
# share of the peak cannot pass 100% by the count.

class _CountNet(Net):
    def mask_logits(self, frames, t, prefix_bb, prefix_head, training, stats, drop=None):
        head = self.kw["decode_head2"]
        feats = self.resnet(frames, t, prefix_bb, training, stats)
        if head.get("input_transform") != "resize_concat":
            return feats, self.fcn(self.mask_input(feats), t, prefix_head, head, training, stats, drop)
        d = int(head.get("dilation", 1))
        picked = [feats[i] for i in head["in_index"]]
        size = picked[0].shape[-2:]
        w0 = t[f"{prefix_head}.convs.0.conv.weight"]
        y, off = None, 0
        for p in picked:
            k = w0[:, off:off + p.shape[1]]
            off += p.shape[1]
            s = size[0] // p.shape[-2]
            part = self.conv(p, k, padding=d // s, dilation=d // s)
            if s != 1:
                part = F.interpolate(part, size=size, mode="bilinear", align_corners=False)
            y = part if y is None else y + part
        x = F.relu(self.bn(y, t, f"{prefix_head}.convs.0.bn", training, stats))
        for i in range(1, int(head.get("num_convs", 2))):
            x = self.conv(x, t[f"{prefix_head}.convs.{i}.conv.weight"], padding=d, dilation=d)
            x = F.relu(self.bn(x, t, f"{prefix_head}.convs.{i}.bn", training, stats))
        return feats, self.conv(x, t[f"{prefix_head}.conv_seg.weight"], t[f"{prefix_head}.conv_seg.bias"])


def step_flops(model_kwargs: dict, pairs: int, hw: int) -> float:
    """Model FLOPs of one training step of ``pairs`` pairs of ``hw``^2 frames."""
    from torch.utils.flop_counter import FlopCounterMode

    kw = dict(model_kwargs)
    for head in ("decode_head2", "decode_head3"):
        kw[head] = dict(kw[head], dropout_ratio=0.0)
    pspec, bspec = specs(kw)
    meta = torch.device("meta")
    params = {n: torch.empty(s, device=meta, requires_grad=True) for n, s, _ in pspec}
    bufs = {n: torch.empty(s, device=meta) for n, s, _ in bspec}
    t = {**params, **bufs}
    net = _CountNet(kw)
    batch = {"imgs": torch.empty(pairs, 2, hw, hw, 3, device=meta),
             "gt_fw_flows": torch.empty(pairs, 1, hw, hw, 2, device=meta),
             "gt_bw_flows": torch.empty(pairs, 1, hw, hw, 2, device=meta)}
    crf = float(kw.get("w_crf", 0)) > 0
    mask = torch.empty(pairs, 2, *kw["mask_size"], device=meta) if crf else None
    with FlopCounterMode(display=False) as counter:
        if crf:
            with torch.no_grad():
                frames = batch["imgs"].reshape(2 * pairs, hw, hw, 3).permute(0, 3, 1, 2)
                net.mask_logits(frames, t, "backbone2_ema", "decode_head2_ema", False, None)
        parts = step_loss(net, t, batch, None, {}, mask)
        torch.autograd.grad(parts["loss"], list(params.values()), allow_unused=True)
    return float(counter.get_total_flops())
