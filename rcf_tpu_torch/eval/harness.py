"""Evaluation harness: per-sequence mIoU, channel election, PNG export
(port of ``rcf_tpu/eval/harness.py``).

As the JAX package and the reference's test/validation path
(`main.py:180-292`, `models/rcf_model.py:241-320`):

* per frame, per channel IoU at the annotation's native resolution
  (on the device, batched);
* channel election: while no object channel is set, the per-frame max-IoU
  channel is tallied (NaN counted as -inf); the argmax of the histogram
  becomes the object channel (`main.py:227-231,241-260`);
* metrics: per-sequence nanmean IoU, their mean (``miou``), and the
  frame-weighted average (``miou_frame_avg``) with the reference's exact
  NaN semantics (plain sum over frames, `main.py:269-292`);
* export: ``pred_seg_{seq}_{frame}_{iter:07}.png`` grayscale masks at 2x
  the mask resolution (`rcf_model.py:254-273,293-315`), one subdirectory
  per channel when ``export_all_seg``.
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from ..data.image_io import write_png
from ..ops.resize import resize_bilinear
from ..utils import get_logger
from .iou import iou_counts

logger = get_logger()


@dataclass
class EvalResult:
    miou: float
    miou_frame_avg: float
    per_sequence: dict
    max_channel_freq: list
    elected_channel: int

    def summary(self, name: str = "val_miou") -> str:
        return f"{name}: {self.miou * 100.:.2f}  {name}_frame_avg: {self.miou_frame_avg * 100.:.2f}"


@dataclass
class Exporter:
    """Writes mask PNGs with the reference contract.

    Several processes would each see the full eval split, so writes are
    sharded by sequence (stable crc32: one process owns a sequence's whole
    directory footprint); with one process (``process_count=1``) it owns
    every sequence.
    """

    save_dir_eval: str
    save_dir_export: str
    export_all_seg: bool = False
    object_channel: int | None = None
    train_iter: int = 0
    process_index: int = 0
    process_count: int = 1
    written: list = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.save_dir_eval, exist_ok=True)
        os.makedirs(self.save_dir_export, exist_ok=True)

    def owns(self, seq: str) -> bool:
        if self.process_count <= 1:
            return True
        import zlib

        return zlib.crc32(seq.encode()) % self.process_count == self.process_index

    def export_batch(self, probs_2x: np.ndarray, seq_names, frame_ids) -> None:
        """probs_2x: [B, H2, W2, C] masks already at 2x mask resolution."""
        channels = range(probs_2x.shape[-1]) if self.export_all_seg else [self.object_channel]
        for ch in channels:
            subdir = os.path.join(self.save_dir_export, str(ch)) if self.export_all_seg else self.save_dir_export
            os.makedirs(subdir, exist_ok=True)
            for bi, (seq, frame) in enumerate(zip(seq_names, frame_ids)):
                if not self.owns(seq):
                    continue
                arr = np.clip(probs_2x[bi, :, :, ch] * 255.0, 0, 255).astype(np.uint8)
                name = f"pred_seg_{seq}_{frame}_{self.train_iter:07}.png"
                write_png(os.path.join(subdir, name), arr)
                self.written.append(name if not self.export_all_seg else f"{ch}/{name}")


@dataclass
class Evaluator:
    eval_pos_th: float = 0.35
    num_channels: int = 4
    object_channel: int | None = None
    always_use_max_iou_channel: bool = False
    exporter: Exporter | None = None

    iou_per_seq: dict = field(default_factory=lambda: defaultdict(list))
    max_channel_freq: np.ndarray = None

    def __post_init__(self):
        self.max_channel_freq = np.zeros(self.num_channels, np.int64)

    def process_batch(self, probs, ann, seq_names, frame_ids=None) -> None:
        """probs [B, h, w, C] (device), ann [B, H, W] uint8 (a tensor)."""
        inter, union = iou_counts(probs, ann, pos_th=self.eval_pos_th)
        inter = inter.cpu().numpy().astype(np.float64)
        union = union.cpu().numpy().astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / union  # NaN where union == 0 (reference semantics)
        use_max = self.always_use_max_iou_channel or self.object_channel is None
        for bi, seq in enumerate(seq_names):
            if use_max:
                # NaNs lose the argmax unless all-NaN (match np.argmax on nan:
                # reference argmax over list with nan picks first occurrence;
                # we treat NaN as -inf which is the sane tally).
                row = np.where(np.isnan(iou[bi]), -np.inf, iou[bi])
                ch = int(np.argmax(row))
                self.max_channel_freq[ch] += 1
                frame_iou = iou[bi, ch]
            else:
                frame_iou = iou[bi, self.object_channel]
            self.iou_per_seq[seq].append(frame_iou)

        if self.exporter is not None:
            h2, w2 = probs.shape[1] * 2, probs.shape[2] * 2
            probs_2x = resize_bilinear(probs.float(), (h2, w2), align_corners=False).cpu().numpy()
            self.exporter.export_batch(probs_2x, seq_names, frame_ids)

    def finalize(self, display_all: bool = False, name: str = "val_miou") -> EvalResult:
        per_seq = {}
        iou_sum, n_frames = 0.0, 0
        for seq, ious in self.iou_per_seq.items():
            per_seq[seq] = float(np.nanmean(ious))
            iou_sum += float(np.sum(ious))  # plain sum: NaN poisons (main.py:276)
            n_frames += len(ious)
            if display_all:
                logger.info(f"{name}_{seq}: {per_seq[seq] * 100.:.2f}")
        miou = float(np.mean(list(per_seq.values()))) if per_seq else 0.0
        frame_avg = iou_sum / max(n_frames, 1)
        elected = int(np.argmax(self.max_channel_freq))
        return EvalResult(miou, frame_avg, per_seq, self.max_channel_freq.tolist(), elected)


def frame_id_from_path(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]
