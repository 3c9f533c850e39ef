"""RCF composite model (port of ``rcf_tpu/models/rcf.py``), channel-last.

A ResNet backbone (``backbone2``) feeding (1) the FCN mask head
(``decode_head2``), (2) the FCN residual head (``decode_head3``) over the
two frames' features, and (3) the flow-aggregation head (``decode_head``)
that rebuilds the ground-truth flow from the masks. ``forward`` returns the
stage-1 loss dict and the mask probabilities; the regularizers are applied
by their config weights.

* The residual head always runs in training mode (batch statistics,
  dropout), as in JAX and the reference: ``train(False)`` leaves it
  training. It is only called by ``forward``.
* The EMA copies ``backbone2_ema`` and ``decode_head2_ema`` exist when
  ``create_ema`` is set; they take no gradient and no optimizer update.
  ``train/state.py`` moves them after each Adam update; ``mask_probs``
  reads them with ``use_ema=True``.
* ``object_channel`` is a Python int or a device tensor (an elected
  channel stays on the card); ``object_channel_set`` gates the losses that
  need it.
* ``dtype`` is the compute dtype of the convolutions and dense layers;
  parameters stay f32, the probabilities and the bf16 losses keep the
  dtypes JAX gives them.

* Stage 2.1's CRF loss (``w_crf > 0``): ``forward`` takes the target masks
  ``crf_target_masks`` [B, I, h, w] and adds ``loss_crf``, the pseudo-label
  loss of the object channel against them (``crf_pos_weight``,
  ``crf_neg_weight``, ``crf_mask_pos_th``). The train step makes the target
  (``train/step.py``: the EMA copies' masks refined by ``ops/crf.py``;
  ``crf_use_ema`` false raises there, as in JAX); ``crf_head_kwargs`` (the
  config's ``crf_head``) are the CRF's settings.
"""

from __future__ import annotations

import copy
import inspect

import torch
from torch import nn

from ..losses.regularizers import (compactness_loss, entropy_loss,
                                    object_aware_sharpen_loss, pseudo_label_loss,
                                    sharpen_loss)
from ..nn import FCNHead, FlowAggregationHead, ResNet
from ..nn.layers import init_weights
from ..ops import resize_bilinear
from ..utils import resolve_device
from .amd.amd_model import maybe_normalize

_DROP = ("type", "create_ema", "loss_decode")


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` step by step: in bf16 the same intermediates round."""
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


def take_channel(probs: torch.Tensor, channel: int | torch.Tensor) -> torch.Tensor:
    """probs [..., C] at one channel, a Python int or a device tensor (no host copy)."""
    if isinstance(channel, torch.Tensor):
        return probs.index_select(-1, channel.reshape(1).to(probs.device)).squeeze(-1)
    if not 0 <= channel < probs.shape[-1]:
        raise ValueError(f"channel {channel} outside [0, {probs.shape[-1]})")
    return probs[..., channel]


def _strip(cfg: dict) -> dict:
    return {k: v for k, v in dict(cfg).items() if k not in _DROP}


def _head_in_channels(cfg: dict, feat_channels) -> int | list:
    """The input channels of an FCN head on features of ``feat_channels``
    (Flax infers them; the config's ``in_channels`` is not read, as in JAX)."""
    index = cfg.get("in_index", -1)
    if cfg.get("input_transform") == "resize_concat":
        return [feat_channels[i] for i in index]
    return feat_channels[index]


def build_model(model_kwargs: dict, device: str | torch.device = "cuda", seed: int = 0,
                dtype: torch.dtype = torch.float32) -> "RCFModel":
    """RCFModel from a reference-shaped ``model_kwargs`` tree, initialized from
    ``seed`` on ``device``, computing in ``dtype``.

    Unknown keys are ignored, as JAX's ``build_model`` does. The weights are
    drawn on the CPU from one ``torch.Generator`` (he-normal convs, N(0, 0.01)
    classifiers), so a seed gives the same model on every device; the EMA
    copies start equal to them.
    """
    dev = resolve_device(device)
    kwargs = dict(model_kwargs)
    crf_cfg = kwargs.pop("crf_head", None)
    if crf_cfg:
        kwargs["crf_head_kwargs"] = {k: v for k, v in dict(crf_cfg).items() if k != "type"}
    backbone_cfg = dict(kwargs.pop("backbone2"))
    create_ema = bool(backbone_cfg.get("create_ema", False))
    heads = {k: _strip(kwargs.pop(k)) for k in ("decode_head", "decode_head2", "decode_head3")}
    compact_cfg = kwargs.pop("compactness_head", None)
    if compact_cfg:
        kwargs["compact_channel"] = compact_cfg["compact_channel"]
    known = inspect.signature(RCFModel).parameters
    kwargs = {k: v for k, v in kwargs.items() if k in known}
    model = RCFModel(_strip(backbone_cfg), heads["decode_head"], heads["decode_head2"],
                     heads["decode_head3"], create_ema=create_ema, dtype=dtype, **kwargs)
    gen = torch.Generator().manual_seed(seed)
    for name in ("backbone2", "decode_head", "decode_head2", "decode_head3"):
        init_weights(getattr(model, name), gen)
    model.decode_head2.init_conv_seg_(gen)
    model.decode_head3.init_conv_seg_(gen)
    model.copy_to_ema_()
    return model.to(dev)


class RCFModel(nn.Module):
    def __init__(self, backbone_cfg: dict, flow_head_cfg: dict, mask_head_cfg: dict,
                 residual_head_cfg: dict, mask_layer: int = 4, mask_size=(96, 96),
                 align_corners: bool = False, w_seg: float = 2.0, w_sharpen: float = 0.0,
                 t_sharpen: float = 0.25, w_entropy: float = 0.0, w_compactness: float = 0.0,
                 compact_channel: int = -1, w_pl: float = 0.0, pl_pos_weight: float = 1.0,
                 pl_neg_weight: float = 1.0, pl_mask_pos_th: float = 0.35,
                 w_crf: float = 0.0, crf_pos_weight: float = 1.0, crf_neg_weight: float = 1.0,
                 crf_mask_pos_th: float = -1.0, crf_use_ema: bool = False,
                 crf_head_kwargs: dict | None = None, ema_m: float = 0.999,
                 separate_residual: bool = False, allow_mask_resize: bool = False,
                 object_aware_sharpening: bool = False, freeze_backbone: bool = False,
                 create_ema: bool = False, dtype: torch.dtype = torch.float32):
        # freeze_backbone acts through the optimizer (train/state.py), as in JAX.
        super().__init__()
        self.mask_layer = mask_layer
        self.mask_size = tuple(mask_size)
        self.align_corners = align_corners
        self.w_seg, self.w_sharpen, self.t_sharpen = w_seg, w_sharpen, t_sharpen
        self.w_entropy, self.w_compactness = w_entropy, w_compactness
        self.compact_channel = compact_channel
        self.w_pl, self.pl_pos_weight, self.pl_neg_weight = w_pl, pl_pos_weight, pl_neg_weight
        self.pl_mask_pos_th = pl_mask_pos_th
        self.w_crf, self.crf_pos_weight, self.crf_neg_weight = w_crf, crf_pos_weight, crf_neg_weight
        self.crf_mask_pos_th, self.crf_use_ema = crf_mask_pos_th, crf_use_ema
        self.crf_head_kwargs = crf_head_kwargs
        self.ema_m = ema_m
        self.separate_residual = separate_residual
        self.allow_mask_resize = allow_mask_resize
        self.object_aware_sharpening = object_aware_sharpening
        self.num_classes = mask_head_cfg["num_classes"]

        self.backbone2 = ResNet(**backbone_cfg, dtype=dtype)
        feat_ch = self.backbone2.out_channels
        self.decode_head = FlowAggregationHead(**flow_head_cfg, dtype=dtype)
        mask_cfg = dict(mask_head_cfg, in_channels=_head_in_channels(mask_head_cfg, feat_ch))
        self.decode_head2 = FCNHead(**mask_cfg, dtype=dtype)
        # The residual head sees both frames: channels twice the backbone's.
        pair_ch = [2 * c for c in (feat_ch if separate_residual else feat_ch[-1:])]
        res_cfg = dict(residual_head_cfg,
                       in_channels=_head_in_channels(residual_head_cfg, pair_ch))
        self.decode_head3 = FCNHead(**res_cfg, dtype=dtype)
        self.has_ema = create_ema
        if create_ema:
            self.backbone2_ema = copy.deepcopy(self.backbone2).requires_grad_(False)
            self.decode_head2_ema = copy.deepcopy(self.decode_head2).requires_grad_(False)

    def train(self, mode: bool = True) -> "RCFModel":
        super().train(mode)
        self.decode_head3.train(True)  # always batch statistics and dropout
        return self

    def copy_to_ema_(self) -> None:
        """Set the EMA copies to the current weights and BN statistics."""
        if self.has_ema:
            self.backbone2_ema.load_state_dict(self.backbone2.state_dict())
            self.decode_head2_ema.load_state_dict(self.decode_head2.state_dict())

    # -- building blocks -------------------------------------------------
    def mask_logits(self, imgs_flat: torch.Tensor, use_ema: bool = False) -> torch.Tensor:
        """imgs [N, H, W, 3] -> mask logits [N, h, w, C] (resized to mask_size if allowed)."""
        backbone = self.backbone2_ema if use_ema else self.backbone2
        head = self.decode_head2_ema if use_ema else self.decode_head2
        return self._maybe_resize(head(backbone(maybe_normalize(imgs_flat))))

    def mask_probs(self, imgs_flat: torch.Tensor, use_ema: bool = False) -> torch.Tensor:
        """Softmax masks [N, h, w, C] from the main or the EMA weights (the eval entry point)."""
        return softmax(self.mask_logits(imgs_flat, use_ema=use_ema), dim=-1)

    def _maybe_resize(self, logits: torch.Tensor) -> torch.Tensor:
        if self.allow_mask_resize and tuple(logits.shape[1:3]) != self.mask_size:
            logits = resize_bilinear(logits, self.mask_size, self.align_corners)
        return logits

    def _residuals(self, feats, batch: int, im_num: int, generator):
        """Forward and backward residuals [B, h, w, 2C] from both frames' features."""
        c = self.num_classes

        def regroup(feat, order):
            # Frame-major channel concat, deferred as a tuple so that conv0
            # of the residual head convolves each frame with its kernel slice.
            f = feat.reshape(batch, im_num, *feat.shape[1:])
            return tuple(f[:, o] for o in order)

        if self.separate_residual:
            out = self.decode_head3([regroup(f, (0, 1)) for f in feats], generator=generator)
            return out[..., :2 * c], out[..., 2 * c:]
        fw = self.decode_head3([regroup(feats[-1], (0, 1))], generator=generator)
        bw = self.decode_head3([regroup(feats[-1], (1, 0))], generator=generator)
        return fw, bw

    def _resize_flows(self, flows: torch.Tensor) -> torch.Tensor:
        """[B, F, H0, W0, 2] -> [B, F, *mask_size, 2]; values unscaled, as the reference."""
        b, fn = flows.shape[:2]
        out = resize_bilinear(flows.reshape(b * fn, *flows.shape[2:]), self.mask_size,
                              self.align_corners)
        return out.reshape(b, fn, *self.mask_size, 2)

    # -- training forward -------------------------------------------------
    def forward(self, imgs: torch.Tensor, gt_fw_flows: torch.Tensor, gt_bw_flows: torch.Tensor,
                pl_masks: torch.Tensor | None = None,
                crf_target_masks: torch.Tensor | None = None,
                object_channel: int | torch.Tensor = 0, object_channel_set: bool = False,
                generator: torch.Generator | None = None):
        """imgs [B, I, H, W, 3] (normalized, or uint8); gt flows [B, I-1, H0, W0, 2];
        pl_masks [B, I, Hp, Wp]; crf_target_masks [B, I, h, w] (stage 2.1's
        target, no gradient). Returns (losses, probs [B, I, h, w, C]).

        ``generator`` drives the heads' channel dropout.
        """
        b, im_num = imgs.shape[:2]
        imgs_flat = imgs.reshape(b * im_num, *imgs.shape[2:])
        feats = self.backbone2(maybe_normalize(imgs_flat))
        logits = self._maybe_resize(self.decode_head2(feats, generator=generator))
        res_fw, res_bw = self._residuals(feats, b, im_num, generator)

        h, w = logits.shape[1:3]
        probs = softmax(logits.reshape(b, im_num, h, w, self.mask_layer), dim=-1)
        flow_losses, _ = self.decode_head(probs, self._resize_flows(gt_fw_flows),
                                          self._resize_flows(gt_bw_flows), res_fw, res_bw)

        losses = {"loss_warp_seg": flow_losses["seg"]}
        loss = flow_losses["seg"] * self.w_seg
        if self.w_sharpen > 0:
            if not self.object_aware_sharpening:
                losses["loss_sharpen"] = sharpen_loss(probs, self.t_sharpen)
            elif object_channel_set:
                losses["loss_sharpen"] = object_aware_sharpen_loss(probs, self.t_sharpen,
                                                                   object_channel)
            if "loss_sharpen" in losses:
                loss = loss + losses["loss_sharpen"] * self.w_sharpen
        elif self.w_entropy > 0:
            losses["loss_entropy"] = entropy_loss(probs)
            loss = loss + losses["loss_entropy"] * self.w_entropy

        if self.w_compactness != 0:
            use_object = self.compact_channel == -1
            if not use_object or object_channel_set:
                idx = object_channel if use_object else self.compact_channel
                compact = take_channel(probs.reshape(b * im_num, h, w, self.mask_layer), idx)
                losses["loss_compactness"] = compactness_loss(compact)
                loss = loss + losses["loss_compactness"] * self.w_compactness

        if self.w_pl > 0 and pl_masks is not None:
            pl = resize_bilinear(pl_masks[..., None], self.mask_size, self.align_corners)[..., 0]
            losses["loss_pl"] = pseudo_label_loss(take_channel(probs, object_channel), pl,
                                                  self.pl_pos_weight, self.pl_neg_weight,
                                                  self.pl_mask_pos_th)
            loss = loss + losses["loss_pl"] * self.w_pl

        if self.w_crf > 0 and crf_target_masks is not None:
            losses["loss_crf"] = pseudo_label_loss(take_channel(probs, object_channel),
                                                   crf_target_masks, self.crf_pos_weight,
                                                   self.crf_neg_weight, self.crf_mask_pos_th)
            loss = loss + losses["loss_crf"] * self.w_crf

        losses["loss"] = loss
        return losses, probs
