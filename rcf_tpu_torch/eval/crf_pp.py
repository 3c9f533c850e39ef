"""Eval-time dense-CRF post-processing (port of ``rcf_tpu/eval/crf_pp.py``).

The reference refines exported masks with CPU pydensecrf over 32 processes
(`tools/pydenseCRF/crf.py`, `crf_parallel.sh`). As there (`crf.py:58-89,
160-190`) and in the JAX package: the mask scaled by 1/0.8 (crf_scale=0.8),
the bilateral kernel sxy=60, srgb=5, compat=5, 50 iterations, at the full
480p resolution; the reference's ``gaussian_filter(sigma=0.1)`` of the
unary is a no-op at uint8 precision and is left out. Masks are resized to
the frame with PIL's default bicubic (``data/pil_resize.py``). Output
masks land in ``<annotation_dir>_crf/`` under their own names.

    python -m rcf_tpu_torch.eval.crf_pp --input data/data_davis/JPEGImages/480p \\
        --annotation-dir <export>/<channel> [--step 0] [--engine native|device]

Engines:

* ``native`` (default): the host C++ permutohedral lattice
  (``ops/crf_native.py``) at full resolution, ``--jobs`` frames at once on
  threads;
* ``device``: the exact O(N^2) mean field on the card, batched over frames
  of one shape (``ops/crf.py::make_crf_fn``, ``crf_filter``), flushed at a
  change of frame shape and at ``--batch`` frames; ``--resolution`` runs it
  on a smaller grid with the spatial widths kept at full-resolution
  geometry, the MAP resized back bilinearly.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np
import torch

from ..data import pil_resize
from ..data.image_io import read_image, write_png
from ..utils import get_logger, resolve_device, set_loglevel

logger = get_logger()


def _collect_frames(input_dir, annotation_dir, step, seq, allow_skip, out_dir):
    jobs = []
    skipped = 0
    for path in sorted(glob(os.path.join(input_dir, seq, "*.jpg"))):
        scene, frame = path.split("/")[-2:]
        ann_path = os.path.join(annotation_dir, f"pred_seg_{scene}_{frame[:-4]}_{step:07}.png")
        if not os.path.exists(ann_path):
            if not allow_skip:
                raise FileNotFoundError(f"{ann_path} missing")
            skipped += 1
            continue
        jobs.append((path, ann_path, os.path.join(out_dir, os.path.basename(ann_path))))
    if skipped:
        logger.info(f"Skipped {skipped} frames without exported masks")
    return jobs


def _load_pair(img_path, ann_path):
    img = read_image(img_path)
    mask = pil_resize.resize(read_image(ann_path, None), (img.shape[1], img.shape[0]))
    if mask.ndim == 3:
        mask = mask[..., 0]
    # crf.py:169: the 0-255 mask scaled by 1/0.8; both engines apply
    # 255/crf_scale to a 0-1 mask, so they are given 0-1.
    return img, mask.astype(np.float32) / 255.0


def _save(path: str, refined: np.ndarray) -> None:
    write_png(path, (refined * 255.0).astype(np.uint8))


def run(input_dir: str, annotation_dir: str, step: int = 0, seq: str = "*",
        allow_skip: bool = False, batch: int = 8, chunk: int = 1024,
        crf_scale: float = 0.8, iters: int = 50, engine: str = "native",
        resolution: tuple[int, int] | None = None, jobs: int = 8,
        device: str = "cuda") -> str:
    """Refine every exported mask of ``seq`` under ``annotation_dir``; returns the
    output directory. ``device`` is the device engine's (the card unless "cpu")."""
    if engine not in ("native", "device"):
        raise ValueError(f"unknown engine {engine!r} (native or device)")
    out_dir = annotation_dir.rstrip("/") + "_crf"
    os.makedirs(out_dir, exist_ok=True)
    frame_jobs = _collect_frames(input_dir, annotation_dir, step, seq, allow_skip, out_dir)

    if engine == "native":
        from ..ops.crf_native import crf_soft_native

        def one(job):
            img_path, ann_path, save_path = job
            img, mask01 = _load_pair(img_path, ann_path)
            _save(save_path, crf_soft_native(img, mask01, refine_iters=iters, crf_scale=crf_scale))

        with ThreadPoolExecutor(max_workers=max(jobs, 1)) as pool:
            list(pool.map(one, frame_jobs))
        return out_dir

    from ..ops.crf import make_crf_fn

    dev = resolve_device(device)
    crf_fn = make_crf_fn(tuple(resolution) if resolution is not None else None, chunk=chunk,
                         crf_scale=crf_scale, refine_iters=iters)
    pending: list[tuple[np.ndarray, np.ndarray, str]] = []

    def flush():
        if not pending:
            return
        imgs = torch.from_numpy(np.stack([p[0] for p in pending])).to(dev)
        masks = torch.from_numpy(np.stack([p[1] for p in pending])).to(dev)
        refined = crf_fn(imgs, masks).cpu().numpy()
        for out, (_, _, save_path) in zip(refined, pending):
            _save(save_path, out)
        pending.clear()

    group_shape = None
    for img_path, ann_path, save_path in frame_jobs:
        img, mask01 = _load_pair(img_path, ann_path)
        if group_shape is not None and img.shape != group_shape:
            flush()
        group_shape = img.shape
        pending.append((img, mask01, save_path))
        if len(pending) == batch:
            flush()
    flush()
    return out_dir


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Batched dense-CRF post-processing")
    parser.add_argument("--input", type=str, required=True, help="JPEGImages directory")
    parser.add_argument("--annotation-dir", type=str, required=True, help="exported masks dir")
    parser.add_argument("--step", type=int, default=0)
    parser.add_argument("--seq", type=str, default="*")
    parser.add_argument("--allow_skip", action="store_true")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=1024)
    parser.add_argument("--engine", choices=["native", "device"], default="native")
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="optional reduced mean-field grid (full-res default)")
    parser.add_argument("--jobs", type=int, default=8, help="native-engine threads")
    return parser.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    args = parse_args(argv)
    set_loglevel(True)
    out = run(args.input, args.annotation_dir, args.step, args.seq, args.allow_skip,
              args.batch, args.chunk, engine=args.engine,
              resolution=tuple(args.resolution) if args.resolution else None,
              jobs=args.jobs, device=device)
    logger.info(f"Refined masks written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
