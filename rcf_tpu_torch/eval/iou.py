"""IoU counts against ground-truth annotations, on the device (port of
``rcf_tpu/eval/iou.py``).

* the masks are resized bilinearly with ``align_corners=True`` to the
  annotation's resolution (``ops/resize.py``);
* ``pos_th != -1`` thresholds every channel independently; ``pos_th == -1``
  takes the channel argmax as a one-hot assignment;
* annotation pixels equal to 128 are ignored; 255 is foreground;
* the (intersection, union) counts are integer sums per frame per channel;
  the ratio, with NaN for an empty union, is formed on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear


def iou_counts(probs: torch.Tensor, ann: torch.Tensor, pos_th: float = 0.35):
    """probs [B, h, w, C]; ann [B, H, W] uint8 -> (intersect, union) [B, C] int64."""
    masks = resize_bilinear(probs.float(), tuple(ann.shape[1:3]), align_corners=True)
    if pos_th == -1:
        pred = F.one_hot(masks.argmax(-1), masks.shape[-1]).bool()
    else:
        pred = masks > pos_th
    ann = ann.to(masks.device)
    valid = (ann != 128)[..., None]
    fg = (ann == 255)[..., None] & valid
    pred = pred & valid
    intersect = (pred & fg).sum(dim=(1, 2))
    union = pred.sum(dim=(1, 2)) + fg.sum(dim=(1, 2)) - intersect
    return intersect, union
