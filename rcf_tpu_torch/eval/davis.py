"""DAVIS16 benchmark evaluator, J (region) and F (boundary) with Hungarian
matching for the unsupervised task (port of ``rcf_tpu/eval/davis.py``).

As the reference's vendored `tools/davis2016-evaluation/` and the JAX package:

* masks: ``pred_seg_{seq}_{frame}_{step:07}.png`` resized bilinearly to the
  annotation's size (PIL's BILINEAR, ``data/pil_resize.py``) and binarized at
  ``> 256 * 0.35`` (`davis2017/results.py:8-48`); annotations read as stored;
* J = Jaccard, an empty union scoring 1 (`davis2017/metrics.py:6-37`);
* F = boundary F-measure of 1-px boundary maps dilated by a disk of radius
  ``ceil(0.008 * diag)`` (`davis2017/metrics.py:40-119,125-178`). The
  dilation is a ``conv2d`` with the disk and zero padding, then ``> 0``:
  cv2's dilation with its default constant border, which never wins a max;
* proposals are assigned to objects by the Hungarian algorithm on mean
  (J+F)/2 (`davis2017/evaluation.py:48-68`, scipy on the host);
* statistics: mean / recall(>0.5) / decay over 4 bins
  (`davis2017/utils.py:135-157`, with the JAX package's uint8 bin indices),
  and the frame-weighted ``J-FrameMean`` (`evaluation_method.py:49-60`).

J and F's pixel counts are computed in torch on ``device`` (the card by
default), a sequence's frames at once; the ratios are taken on the host in
float64 from the exact integer counts, as numpy takes them.

    python -m rcf_tpu_torch.eval.davis --davis_path data/data_davis \\
        --results_path <export>/0 [--set val] [--year 2016] [--step 0]
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import warnings
from glob import glob

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..data import pil_resize
from ..data.image_io import read_image
from ..utils import resolve_device

POS_TH = 0.35


# ---------------------------------------------------------------------------
# Metrics.
# ---------------------------------------------------------------------------


def _bool(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device).bool()


def jaccard(annotation, segmentation, device: str = "cuda") -> np.ndarray:
    """Binary IoU over the last two axes (float64); empty-union frames score 1."""
    dev = resolve_device(device)
    a, s = _bool(annotation, dev), _bool(segmentation, dev)
    inters = (a & s).sum((-2, -1)).cpu().numpy()
    union = (a | s).sum((-2, -1)).cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        j = inters / union
    return np.where(np.isclose(union, 0), 1.0, j)


def _seg2bmap(seg: torch.Tensor) -> torch.Tensor:
    """1-px-wide boundary maps of [..., H, W] bool masks (David Martin's bmap,
    the same-size path)."""
    e = torch.zeros_like(seg)
    s = torch.zeros_like(seg)
    se = torch.zeros_like(seg)
    e[..., :, :-1] = seg[..., :, 1:]
    s[..., :-1, :] = seg[..., 1:, :]
    se[..., :-1, :-1] = seg[..., 1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[..., -1, :] = seg[..., -1, :] ^ e[..., -1, :]
    b[..., :, -1] = seg[..., :, -1] ^ s[..., :, -1]
    b[..., -1, -1] = False
    return b


def _disk(radius: int) -> np.ndarray:
    """Disk structuring element (skimage.morphology.disk)."""
    r = np.arange(-radius, radius + 1)
    x, y = np.meshgrid(r, r)
    return ((x**2 + y**2) <= radius**2).astype(np.uint8)


def _dilate(b: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation of [T, H, W] bool maps by a disk, outside pixels never set."""
    k = torch.from_numpy(_disk(radius)).to(device=b.device, dtype=torch.float32)[None, None]
    return torch.nn.functional.conv2d(b[:, None].float(), k, padding=radius)[:, 0] > 0


def _f_from_counts(n_fg: int, n_gt: int, fg_match: int, gt_match: int) -> float:
    if n_fg == 0 and n_gt > 0:
        return 0.0
    if n_fg > 0 and n_gt == 0:
        return 0.0  # precision 0, recall 1 -> F 0
    if n_fg == 0 and n_gt == 0:
        return 1.0
    precision = fg_match / float(n_fg)
    recall = gt_match / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def boundary_f_frames(foreground, gt, bound_th: float = 0.008,
                      device: str = "cuda") -> np.ndarray:
    """Boundary F-measure of each frame of [T, H, W] masks -> [T] float64."""
    dev = resolve_device(device)
    fg, g = _bool(foreground, dev), _bool(gt, dev)
    bound_pix = bound_th if bound_th >= 1 else math.ceil(
        bound_th * np.linalg.norm(tuple(fg.shape[-2:])))
    fg_b, gt_b = _seg2bmap(fg), _seg2bmap(g)
    fg_dil, gt_dil = _dilate(fg_b, int(bound_pix)), _dilate(gt_b, int(bound_pix))
    counts = torch.stack([fg_b.sum((-2, -1)), gt_b.sum((-2, -1)),
                          (fg_b & gt_dil).sum((-2, -1)), (gt_b & fg_dil).sum((-2, -1))], 1)
    return np.array([_f_from_counts(*(int(v) for v in row)) for row in counts.cpu().numpy()],
                    np.float64).reshape(fg.shape[:-2])


def boundary_f_measure(foreground, gt, bound_th: float = 0.008, device: str = "cuda") -> float:
    """Boundary F-measure of one [H, W] frame."""
    return float(boundary_f_frames(foreground[None], gt[None], bound_th, device)[0])


def db_statistics(per_frame: np.ndarray) -> tuple[float, float, float]:
    """(mean, recall@0.5, decay over 4 temporal bins)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        m = np.nanmean(per_frame)
        r = np.nanmean(per_frame > 0.5)
    n_bins = 4
    ids = np.round(np.linspace(1, len(per_frame), n_bins + 1) + 1e-10) - 1
    ids = ids.astype(np.uint8)  # the JAX package's (and reference's) uint8 quirk
    bins = [per_frame[ids[i]: ids[i + 1] + 1] for i in range(n_bins)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        d = np.nanmean(bins[0]) - np.nanmean(bins[3])
    return float(m), float(r), float(d)


# ---------------------------------------------------------------------------
# Dataset and results.
# ---------------------------------------------------------------------------


def list_sequences(davis_root: str, subset: str) -> dict:
    """{seq: [frame_id, ...]} from an rcf-style split (root/<subset>.txt), or
    the Annotations folder of an official DAVIS layout."""
    split_path = os.path.join(davis_root, f"{subset}.txt")
    seqs: dict = {}
    if os.path.exists(split_path):
        with open(split_path) as f:
            for line in sorted(f.readlines()):
                parts = line.split()
                if not parts:
                    continue
                seq = parts[0].rstrip("/").split("/")[-1]
                seqs[seq] = [os.path.splitext(p)[0] for p in parts[1:]]
        return seqs
    ann_root = os.path.join(davis_root, "Annotations", "480p")
    for seq in sorted(os.listdir(ann_root)):
        frames = sorted(glob(os.path.join(ann_root, seq, "*.png")))
        seqs[seq] = [os.path.splitext(os.path.basename(p))[0] for p in frames]
    return seqs


def read_gt_masks(davis_root: str, seq: str, frame_ids, separate_objects: bool) -> np.ndarray:
    ann_dir = os.path.join(davis_root, "Annotations", "480p", seq)
    masks = np.stack([read_image(os.path.join(ann_dir, f"{fid}.png"), None) for fid in frame_ids])
    if masks.ndim == 4:
        masks = masks[..., 0]
    if separate_objects:
        ids = np.arange(1, int(masks[0].max()) + 1)[:, None, None, None]
        return masks[None] == ids
    return (masks > 0)[None]


def read_result_masks(results_path: str, seq: str, frame_ids, step: int,
                      target_wh: tuple[int, int] = (854, 480)) -> np.ndarray:
    out = []
    for fid in frame_ids:
        path = os.path.join(results_path, f"pred_seg_{seq}_{fid}_{step:07}.png")
        if not os.path.exists(path):
            matches = glob(os.path.join(results_path, f"pred_seg_{seq}_*_{fid}_{step:07}.png"))
            if len(matches) != 1:
                raise FileNotFoundError(f"missing/ambiguous result mask for {seq}/{fid}")
            path = matches[0]
        arr = pil_resize.resize(read_image(path, None), target_wh, pil_resize.BILINEAR)
        if arr.ndim == 3:
            arr = arr[..., 0]
        out.append((arr > 256 * POS_TH).astype(np.uint8))
    masks = np.stack(out)
    ids = np.arange(1, max(int(masks.max()), 1) + 1)[:, None, None, None]
    return masks[None] == ids


# ---------------------------------------------------------------------------
# Evaluation.
# ---------------------------------------------------------------------------


def evaluate_unsupervised(gt_masks, res_masks, max_n_proposals: int = 20,
                          device: str = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """gt [O, T, H, W]; res [P, T, H, W] -> the matched (J, F), [O, T] each."""
    if res_masks.shape[0] > max_n_proposals:
        raise ValueError(f"{res_masks.shape[0]} proposals, at most {max_n_proposals}")
    if res_masks.shape[0] < gt_masks.shape[0]:
        pad = np.zeros((gt_masks.shape[0] - res_masks.shape[0], *res_masks.shape[1:]), bool)
        res_masks = np.concatenate([res_masks, pad], axis=0)
    n_p, n_o, n_t = res_masks.shape[0], gt_masks.shape[0], gt_masks.shape[1]
    j = np.zeros((n_p, n_o, n_t))
    f = np.zeros((n_p, n_o, n_t))
    for oi in range(n_o):
        for pi in range(n_p):
            j[pi, oi] = jaccard(gt_masks[oi], res_masks[pi], device)
            f[pi, oi] = boundary_f_frames(res_masks[pi], gt_masks[oi], device=device)
    score = (j.mean(axis=2) + f.mean(axis=2)) / 2
    row, col = linear_sum_assignment(-score)
    return j[row, col], f[row, col]


def evaluate(davis_root: str, results_path: str, subset: str = "val", year: str = "2016",
             step: int = 0, metrics=("J", "F"), device: str = "cuda") -> dict:
    seqs = list_sequences(davis_root, subset)
    separate_objects = year != "2016"
    res: dict = {m: {"M": [], "R": [], "D": [], "M_per_object": {}, "seq_len": {}}
                 for m in metrics}
    for seq, frame_ids in seqs.items():
        gt = read_gt_masks(davis_root, seq, frame_ids, separate_objects)
        # Predictions at the annotations' size (854x480 on real DAVIS).
        pred = read_result_masks(results_path, seq, frame_ids, step,
                                 target_wh=(gt.shape[-1], gt.shape[-2]))
        j, f = evaluate_unsupervised(gt, pred, device=device)
        for oi in range(gt.shape[0]):
            name = f"{seq}_{oi + 1}"
            for metric, values in (("J", j), ("F", f)):
                if metric not in res:
                    continue
                m, r, d = db_statistics(values[oi])
                res[metric]["M"].append(m)
                res[metric]["R"].append(r)
                res[metric]["D"].append(d)
                res[metric]["M_per_object"][name] = m
                res[metric]["seq_len"][name] = gt.shape[1]
    return res


def summarize(res: dict) -> dict:
    j, f = res["J"], res["F"]
    sum_j = sum(j["M_per_object"][k] * j["seq_len"][k] for k in j["M_per_object"])
    n_frames = sum(j["seq_len"].values())
    return {
        "J&F-Mean": (np.mean(j["M"]) + np.mean(f["M"])) / 2,
        "J-Mean": float(np.mean(j["M"])),
        "J-FrameMean": sum_j / n_frames,
        "J-Recall": float(np.mean(j["R"])),
        "J-Decay": float(np.mean(j["D"])),
        "F-Mean": float(np.mean(f["M"])),
        "F-Recall": float(np.mean(f["R"])),
        "F-Decay": float(np.mean(f["D"])),
    }


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="DAVIS J&F evaluation (unsupervised)")
    parser.add_argument("--davis_path", type=str, required=True)
    parser.add_argument("--results_path", type=str, required=True)
    parser.add_argument("--set", type=str, default="val")
    parser.add_argument("--year", type=str, default="2016", choices=["2016", "2017", "2019"])
    parser.add_argument("--step", type=int, default=0)
    return parser.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    args = parse_args(argv)
    res = evaluate(args.davis_path, args.results_path, args.set, args.year, args.step,
                   device=device)
    summary = summarize(res)
    print(",".join(summary))
    print(",".join(f"{v:.3f}" for v in summary.values()))
    print("\nPer-sequence J:")
    for name, value in res["J"]["M_per_object"].items():
        print(f"  {name}: {value * 100:.2f}")
    out_csv = os.path.join(args.results_path, f"global_results-{args.set}.csv")
    with open(out_csv, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(summary.keys())
        writer.writerow(f"{v:.3f}" for v in summary.values())
    print(f"\nGlobal results saved in {out_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
