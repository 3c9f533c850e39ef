"""SegTrackv2 / FBMS59 evaluation at the annotations' resolution
(port of ``rcf_tpu/eval/stv2_fbms.py``).

As `tools/STv2-FBMS59-evaluation/eval_tool.py`: per frame, the exported
mask resized to the annotation's size with PIL's default bicubic (the
reference's bare ``Image.resize``; ``data/pil_resize.py``, bit for bit),
the annotation binarized at > 0.5 and the prediction at > 0.35, IoU (NaN
for an empty union), per-sequence nanmean, and the frame-weighted global
nanmean. Host numpy only: a frame's IoU is two counts.

    python -m rcf_tpu_torch.eval.stv2_fbms --dataset SegTrackv2 --pred_dir <dir> \\
        [--data-root data/data_SegTrackv2] [--step 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import pil_resize
from ..data.image_io import read_image

POS_TH = 0.35

DATASETS = {
    # dataset: (default data_root, split file, annotations are PNGs, GT may be missing)
    "SegTrackv2": ("data/data_SegTrackv2", "trainval.txt", False, False),
    "FBMS59": ("data/data_fbms59", "val_all.txt", True, True),
}


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    union = (a | b).sum()
    if union == 0:
        return float("nan")
    return float((a & b).sum() / union)


def evaluate(dataset: str, pred_dir: str, data_root: str | None = None,
             split_file: str | None = None, step: int = 0) -> dict:
    default_root, default_split, use_png, allow_skip = DATASETS[dataset]
    data_root = data_root or default_root
    with open(os.path.join(data_root, split_file or default_split)) as f:
        lines = [ln.split() for ln in f.readlines() if ln.strip()]

    per_seq = {}
    all_ious = []
    for parts in lines:
        seq_dir = parts[0].replace("JPEGImages", "Annotations")
        seq_name = seq_dir.rstrip("/").split("/")[-1]
        seq_ious = []
        for frame_ind, frame in enumerate(parts[1:]):
            path = os.path.join(data_root, seq_dir, frame)
            if use_png:
                path = path.replace(".jpg", ".png")
            if not os.path.exists(path):
                if not allow_skip:
                    raise FileNotFoundError(f"{path} missing and skipping GT not allowed")
                continue
            ann = read_image(path, None) / 255.0
            if ann.ndim == 3:
                ann = ann[..., 0]
            pred_path = os.path.join(pred_dir, f"pred_seg_{seq_name}_{frame_ind:05}_{step:07}.png")
            pred = pil_resize.resize(read_image(pred_path, None), (ann.shape[1], ann.shape[0]))
            pred = pred / 255.0
            if pred.ndim == 3:
                pred = pred[..., 0]
            seq_ious.append(_iou(pred > POS_TH, ann > 0.5))
        per_seq[seq_name] = float(np.nanmean(seq_ious)) if seq_ious else float("nan")
        all_ious += seq_ious
    return {"per_sequence": per_seq, "miou": float(np.nanmean(all_ious)),
            "num_frames": len(all_ious)}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="STv2/FBMS59 IoU evaluation")
    parser.add_argument("--dataset", choices=list(DATASETS), required=True)
    parser.add_argument("--pred_dir", type=str, required=True)
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--split-file", type=str, default=None)
    parser.add_argument("--step", type=int, default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    res = evaluate(args.dataset, args.pred_dir, args.data_root, args.split_file, args.step)
    for seq, miou in res["per_sequence"].items():
        print(f"mIoU on {seq}: {miou * 100:.2f}")
    print(f"mIoU: {res['miou'] * 100:.2f}")
    print(f"Number of frames: {res['num_frames']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
