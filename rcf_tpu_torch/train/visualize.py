"""Training and eval visualization grids (port of ``rcf_tpu/train/visualize.py``).

Every ``log_interval`` steps the loop saves a JPEG grid of one sample:
per-channel masks for both frames, the frames themselves, and the
colorized pred/gt/aggregated/affine/residual flows, plus pseudo-labels
when present (`models/rcf_model.py:456-608` of the reference); eval saves
the frame stacked over each channel's mask. The grid's forward
(``vis_forward``) is the model's forward in eval mode with no gradient,
returning the probabilities and the flow head's flows; the JPEGs go
through the port's own encoder (quality 90).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.image_io import write_jpeg
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..models.amd.amd_model import maybe_normalize
from ..ops.resize import resize_bilinear
from ..utils.flow_vis import flow_to_color


@torch.no_grad()
def vis_forward(model, imgs: torch.Tensor, gt_fw_flows: torch.Tensor,
                gt_bw_flows: torch.Tensor):
    """An RCF model's probabilities [B, I, h, w, C] and its flows
    {kind: (fw, bw)} of [B, h, w, 2], in eval mode, without gradient."""
    was_training = model.training
    # The residual head always runs on batch statistics, which would move its
    # running statistics: they are put back after, as JAX drops the vis
    # step's batch statistics.
    saved = {k: v.clone() for k, v in model.decode_head3.state_dict().items()}
    model.eval()
    try:
        b, im_num = imgs.shape[:2]
        imgs_flat = imgs.reshape(b * im_num, *imgs.shape[2:])
        feats = model.backbone2(maybe_normalize(imgs_flat))
        logits = model._maybe_resize(model.decode_head2(feats))
        res_fw, res_bw = model._residuals(feats, b, im_num, None)
        h, w = logits.shape[1:3]
        probs = torch.softmax(logits.reshape(b, im_num, h, w, model.mask_layer).float(), dim=-1)
        _, flows = model.decode_head(probs, model._resize_flows(gt_fw_flows),
                                     model._resize_flows(gt_bw_flows), res_fw, res_bw)
    finally:
        model.decode_head3.load_state_dict(saved)
        model.train(was_training)
    return probs, flows


def _to_u8(x01: np.ndarray) -> np.ndarray:
    return np.clip(x01 * 255.0, 0, 255).astype(np.uint8)


def _unnormalize(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0, 1)


def _resize(x: np.ndarray, hw) -> np.ndarray:
    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(x, np.float32)), tuple(hw)).numpy()


def compose_train_grid(imgs: np.ndarray, probs: np.ndarray, flows: dict,
                       pl_masks: np.ndarray | None = None, sample: int = 0) -> np.ndarray:
    """One batch sample -> RGB grid in [0, 1] (rows = visualization kinds).

    imgs [B, I, H, W, 3] (normalized or uint8); probs [B, I, h, w, C];
    flows: dict of (fw, bw) pairs of [B, h', w', 2] from the flow head.
    """
    b, im_num, h, w, c = probs.shape
    rows = []
    for ch in range(c):
        rows.append(np.concatenate(
            [np.repeat(probs[sample, i, :, :, ch : ch + 1], 3, axis=-1) for i in range(im_num)],
            axis=1,
        ))
    raw = imgs[sample]
    imgs_small = _resize(_unnormalize(raw), (h, w))
    rows.append(np.concatenate([np.clip(imgs_small[i], 0, 1) for i in range(im_num)], axis=1))
    for kind in ("pred_flow", "gt_flow", "agg_flow", "affine_flow", "residual_adj"):
        if kind not in flows:
            continue
        fw, bw = flows[kind]
        fw_r = _resize(fw[sample : sample + 1], (h, w))[0]
        bw_r = _resize(bw[sample : sample + 1], (h, w))[0]
        rows.append(np.concatenate(
            [flow_to_color(fw_r) / 255.0, flow_to_color(bw_r) / 255.0], axis=1))
    if pl_masks is not None:
        pl = _resize(np.asarray(pl_masks[sample])[..., None], (h, w))[..., 0]
        rows.append(np.concatenate(
            [np.repeat(pl[i][..., None], 3, axis=-1) for i in range(im_num)], axis=1))
    return np.concatenate(rows, axis=0)


def save_train_grid(save_dir: str, train_iter: int, seq_name: str, frame_id: str,
                    grid01: np.ndarray) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(
        save_dir, f"train_iter{train_iter:07d}_{seq_name}_{frame_id}_img_pred_recons.jpg"
    )
    write_jpeg(path, _to_u8(grid01), quality=90)
    return path


def save_eval_visualization(save_dir: str, name: str, img: np.ndarray,
                            probs: np.ndarray) -> str:
    """img [H, W, 3] normalized (or uint8); probs [h, w, C]. Stacks the image
    over each channel's mask at 2x mask resolution (rcf_model.py:291-305)."""
    os.makedirs(save_dir, exist_ok=True)
    h2, w2 = probs.shape[0] * 2, probs.shape[1] * 2
    panels = [np.clip(_resize(_unnormalize(img)[None], (h2, w2))[0], 0, 1)]
    for ch in range(probs.shape[-1]):
        m = _resize(probs[None, :, :, ch : ch + 1], (h2, w2))[0]
        panels.append(np.repeat(m, 3, axis=-1))
    grid = np.concatenate(panels, axis=0)
    path = os.path.join(save_dir, f"{name}.jpg")
    write_jpeg(path, _to_u8(grid), quality=90)
    return path
