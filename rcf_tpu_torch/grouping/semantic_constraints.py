"""Stage-2.2 pseudo-labels: CRF -> NCut refinement -> CRF -> merge
(port of ``rcf_tpu/grouping/semantic_constraints.py``).

As `tools/SemanticConstraintsAndMAA/semantic_constraints.py`, for each
exported frame of the object channel:

1. dense-CRF refine the raw mask (crf_scale=0.7)               (`:306-309`)
2. 10-step Adam NCut refinement against DINO affinities
   (lr 0.45, clamp [0,1])                                      (`:41-75,311`)
3. dense-CRF the NCut-refined mask (crf_scale=0.5)             (`:312-313`)
4. merge = product of (1) and (3); on FBMS59, keep (1) alone when the
   union-minus-intersection of their binarizations exceeds umi_th=10000
   ("likely captures different things")                        (`:315-325`)

Pseudo-labels land in ``<export>_torchcrf_ncut_torchcrf/<channel>/`` with
the export's ``pred_seg_{seq}_{frame}_0000000.png`` names, which the
stage-2.2 loader reads (``data/dataset.py``, ``pl_root``).

    python -m rcf_tpu_torch.grouping.semantic_constraints \\
        --pretrain_dir saved/saved_rcf_stage2.1 --dataset davis --object-channel N

CRF engines (``--crf-engine``): ``native``, the host C++ permutohedral
lattice (``ops/crf_native.py``); ``attention``, the exact mean field on the
card (``ops/crf.py::crf_soft_single``, ``crf_filter``). ``auto`` means
``native``, and a failed native build raises (the JAX package quietly takes
the attention engine then; the port never switches engines by itself). The
engine in use is logged. Frames go in groups of ``THREADS``: the CRF
passes run a frame a thread (the lattice releases the GIL), step 2 once
for the group on the card (``semantic_refine``: one ViT batch, then each
frame's NCut); each frame's output does not depend on the others.
"""

from __future__ import annotations

import argparse
import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np
import torch

from ..data.image_io import write_png
from ..ops.crf import CRFParams, crf_soft_single
from ..ops.resize import resize_bilinear
from ..utils import get_logger, set_loglevel
from ..utils.precision import full_f32
from .maa import load_image, load_pred_mask
from .ncut import ncut_refine
from .pipeline import DATA_ROOTS, VAL_SEQS, DinoFeatures

logger = get_logger()

SAVE_SUFFIX = "_torchcrf_ncut_torchcrf"
EXPORT_DIR_BY_DATASET = {
    "davis": "saved_eval_export_trainval_ema",
    "stv2": "saved_eval_export_ema",
    "fbms59": "saved_eval_export_trainval_ema",
}
ENGINES = ("native", "attention")
# Frames refined at once: a host core each for the lattice, and one ViT batch
# on the card (~1 GB of attention weights a frame at 480p, several times that
# at the softmax's peak).
THREADS = 8


def _engine(engine: str) -> str:
    engine = "native" if engine == "auto" else engine
    if engine not in ENGINES:
        raise ValueError(f"unknown CRF engine {engine!r} (auto, native or attention)")
    return engine


def resolve_crf_engine(engine: str) -> str:
    """``auto`` -> ``native`` (built here, so a failed build raises now)."""
    engine = _engine(engine)
    if engine == "native":
        from ..ops import crf_native

        crf_native.build()
    return engine


def _crf_pass(rgb_u8: np.ndarray, mask01: torch.Tensor, params: CRFParams, chunk: int,
              engine: str) -> np.ndarray:
    """One full-resolution dense-CRF refinement with ``engine`` -> [H, W] f32 numpy."""
    if engine == "native":
        from ..ops.crf_native import crf_soft_native

        return crf_soft_native(
            rgb_u8, mask01.cpu().numpy(), srgb=params.srgb, scomp=params.scomp, sxy=params.sxy,
            scomp_smooth=params.scomp_smooth, sxy_smooth=params.sxy_smooth,
            refine_iters=params.refine_iters, crf_scale=params.crf_scale)
    rgb = torch.from_numpy(rgb_u8).to(mask01.device)
    return crf_soft_single(rgb, mask01, params, chunk).cpu().numpy()


def _aligned_mask(dino: DinoFeatures, mask, hw: tuple[int, int]) -> torch.Tensor:
    """The exported mask on the device at the frame's size (masks are loaded at
    the 480p export size: bilinear to the frame where they differ)."""
    mask_t = dino.to_device(mask)
    if tuple(mask_t.shape) != hw:
        with full_f32():
            mask_t = resize_bilinear(mask_t[None, ..., None], hw)[0, ..., 0]
    return mask_t


def _first_pass(dino: DinoFeatures, img01: np.ndarray, mask, crf_chunk: int,
                engine: str) -> tuple[np.ndarray, torch.Tensor, np.ndarray]:
    """Step 1 of one frame: (its uint8 RGB, its mask on the device, the CRF-refined mask)."""
    rgb_u8 = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    mask_t = _aligned_mask(dino, mask, img01.shape[:2])
    with full_f32():
        crf_np = _crf_pass(rgb_u8, mask_t, CRFParams(crf_scale=0.7), crf_chunk, engine)
    return rgb_u8, mask_t, crf_np


def semantic_refine(dino: DinoFeatures, imgs01, masks) -> torch.Tensor:
    """Step 2, the device stage, for B frames of one size: imgs01 [B, H, W, 3]
    RGB in [0, 1] and masks [B, H, W] soft in [0, 1] (numpy or tensors) ->
    the NCut-refined masks [B, h, w] at the feature grid (60 x 107 at 480 x
    856), on the device. The keys of the B frames come from one ``dino``
    call; each frame's mask goes to the grid, then its own affinity and
    refinement, the B frames in one ``ncut_refine`` call. Nothing here
    waits for the device."""
    feats = dino(imgs01)
    grids = dino.mask_to_grid(masks)
    with full_f32():
        return ncut_refine(feats, grids)


def _second_pass(rgb_u8: np.ndarray, crf_np: np.ndarray, refined_grid: torch.Tensor,
                 umi_th: float | None, crf_chunk: int, engine: str) -> np.ndarray:
    """Steps 3 and 4 of one frame: the refined mask at the frame's size, its
    CRF pass, and the merge with step 1's."""
    hw = rgb_u8.shape[:2]
    with full_f32():
        refined_full = resize_bilinear(refined_grid[None, ..., None], hw)[0, ..., 0]
    ncut_np = _crf_pass(rgb_u8, refined_full, CRFParams(crf_scale=0.5), crf_chunk, engine)

    b = ncut_np > 0.5
    if not b.any() or b.all():
        # A degenerate NCut pass (empty or full: broken features or weights)
        # would zero or no-op the merged label: keep the CRF-only one, as the
        # reference's umi guard does when the two "capture different things".
        logger.warning("NCut-refined mask degenerate; keeping CRF-only PL")
        return crf_np
    if umi_th is not None:
        a = crf_np > 0.5
        if float(np.sum(a | b) - np.sum(a & b)) > umi_th:
            return crf_np  # likely capture different things: skip the merge
    return crf_np * ncut_np


def refine_group(dino: DinoFeatures, imgs01: list, masks: list, umi_th: float | None,
                 pool: ThreadPoolExecutor | None = None, crf_chunk: int = 1024,
                 crf_engine: str = "auto") -> list[np.ndarray]:
    """Each frame's pseudo-label [H, W] f32 (see the module note): the CRF passes
    per frame on ``pool``'s threads, ``semantic_refine`` once for each run of
    frames of one size. A frame's label does not depend on the others'."""
    engine = _engine(crf_engine)
    run = pool.map if pool is not None else map
    firsts = list(run(lambda im, m: _first_pass(dino, im, m, crf_chunk, engine), imgs01, masks))
    refined: list = []
    for _, run_of_size in itertools.groupby(range(len(imgs01)), key=lambda i: imgs01[i].shape):
        idx = list(run_of_size)
        refined += list(semantic_refine(dino, np.stack([imgs01[i] for i in idx]),
                                        torch.stack([firsts[i][1] for i in idx])))
    return list(run(lambda f, r: _second_pass(f[0], f[2], r, umi_th, crf_chunk, engine),
                    firsts, refined))


def refine_frame(dino: DinoFeatures, img01: np.ndarray, mask: np.ndarray,
                 umi_th: float | None, crf_chunk: int = 1024,
                 crf_engine: str = "auto") -> np.ndarray:
    """One frame's pseudo-label [H, W] f32 (``refine_group`` of one frame);
    ``crf_engine`` ``auto`` is ``native``, whose failed build raises."""
    return refine_group(dino, [img01], [mask], umi_th, None, crf_chunk, crf_engine)[0]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Generate semantic-constraint pseudo-labels")
    parser.add_argument("--pretrain_dir", type=str, required=True)
    parser.add_argument("--object-channel", type=int, required=True)
    parser.add_argument("--dataset", type=str, default="davis", choices=list(VAL_SEQS))
    parser.add_argument("--data-dir", type=str, default="data")
    parser.add_argument("--export-dir-name", type=str, default=None)
    parser.add_argument("--dino-checkpoint", type=str, default=None)
    parser.add_argument("--crf-engine", choices=["auto", "native", "attention"], default="auto",
                        help="dense-CRF engine of the two refinement passes (auto: the "
                             "native lattice; a failed build raises)")
    parser.add_argument("--val-only", action="store_true",
                        help="refine validation sequences only (default: all)")
    return parser.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    args = parse_args(argv)
    set_loglevel(True)
    export_dir_name = args.export_dir_name or EXPORT_DIR_BY_DATASET[args.dataset]
    data_root, images_sub = DATA_ROOTS[args.dataset]
    images_dir = os.path.join(args.data_dir, os.path.basename(data_root), images_sub)
    pred_dir = os.path.join(args.pretrain_dir, export_dir_name)
    umi_th = 10000 if args.dataset == "fbms59" else None

    seqs = sorted(s for s in os.listdir(images_dir) if not s.startswith("."))
    if args.val_only:
        seqs = VAL_SEQS[args.dataset]
    out_dir = os.path.join(args.pretrain_dir, export_dir_name + SAVE_SUFFIX,
                           str(args.object_channel))
    os.makedirs(out_dir, exist_ok=True)
    logger.info(f"Start refinement: {out_dir}")

    engine = resolve_crf_engine(args.crf_engine)
    logger.info(f"CRF engine: {engine}")
    dino = DinoFeatures(checkpoint=args.dino_checkpoint, device=device)

    jobs = [(seq, os.path.splitext(os.path.basename(p))[0])
            for seq in seqs for p in sorted(glob(os.path.join(images_dir, seq, "*.jpg")))]
    last_of = {seq: i for i, (seq, _) in enumerate(jobs)}

    def load(job: tuple[str, str]) -> tuple[np.ndarray, np.ndarray]:
        seq, frame = job
        return (load_image(images_dir, seq, frame),
                load_pred_mask(pred_dir, args.object_channel, seq, frame, step=0))

    with ThreadPoolExecutor(max_workers=THREADS) as pool:
        for start in range(0, len(jobs), THREADS):
            group = jobs[start:start + THREADS]
            paths = [os.path.join(out_dir, f"pred_seg_{seq}_{frame}_0000000.png")
                     for seq, frame in group]
            for out_path in paths:
                if os.path.exists(out_path):
                    raise FileExistsError(f"refusing to overwrite {out_path}")
            imgs, masks = zip(*pool.map(load, group))
            refined = refine_group(dino, list(imgs), list(masks), umi_th, pool,
                                   crf_engine=engine)
            list(pool.map(lambda path, r: write_png(path, (r * 255.0).astype(np.uint8)),
                          paths, refined))
            for i, (seq, _) in enumerate(group, start):
                if last_of[seq] == i:
                    logger.info(f"refined sequence {seq}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
