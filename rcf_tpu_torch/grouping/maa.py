"""Motion-appearance alignment (MAA) channel election (port of ``rcf_tpu/grouping/maa.py``).

As `tools/SemanticConstraintsAndMAA/maa.py`: for each candidate channel,
the exported masks' soft NCut against the DINO affinity, over the
validation sequences (optionally their first frames only); MAA is the
negated NCut averaged over frames. The best channel is logged and, as in
the reference, returned as the process exit code (`maa.py:398-402`).

    python -m rcf_tpu_torch.grouping.maa --pretrain_dir saved/saved_rcf_stage1 \\
        --dataset davis --first-frames-only [--num-channels 4] [--step 0]; OBJECT_CHANNEL=$?

Masks are read as stored and resized to 854x480 with PIL's default
bicubic (``data/pil_resize.py``, bit for bit); frames are decoded by the
port's codec. Runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np

from ..data import pil_resize
from ..data.image_io import read_image
from ..utils import get_logger, set_loglevel
from .ncut import soft_ncut_value
from .pipeline import DATA_ROOTS, VAL_SEQS, DinoFeatures

logger = get_logger()

IMG_SIZE = (480, 854)


def load_pred_mask(pred_dir: str, channel: int, seq: str, frame: str, step: int) -> np.ndarray:
    path = os.path.join(pred_dir, str(channel), f"pred_seg_{seq}_{frame}_{step:07}.png")
    mask = pil_resize.resize(read_image(path, None), (IMG_SIZE[1], IMG_SIZE[0]))
    arr = mask.astype(np.float32) / 255.0
    return arr[..., 0] if arr.ndim == 3 else arr


def load_image(images_dir: str, seq: str, frame: str) -> np.ndarray:
    return read_image(os.path.join(images_dir, seq, f"{frame}.jpg")).astype(np.float32) / 255.0


def maa_for_channel(dino: DinoFeatures, images_dir: str, pred_dir: str, channel: int,
                    seqs, step: int, first_frames_only: bool, gt_dir: str | None = None) -> float:
    values = []
    for seq in seqs:
        for frame_path in sorted(glob(os.path.join(images_dir, seq, "*.jpg"))):
            frame = os.path.splitext(os.path.basename(frame_path))[0]
            if gt_dir is not None and not os.path.exists(os.path.join(gt_dir, seq, f"{frame}.png")):
                continue  # fbms59: frames without GT are skipped (maa.py:250-255)
            img = load_image(images_dir, seq, frame)
            mask = load_pred_mask(pred_dir, channel, seq, frame, step)
            feats = dino(img[None])[0]
            values.append(-float(soft_ncut_value(feats, dino.mask_to_grid(mask))))
            if first_frames_only:
                break
    if not values:
        raise FileNotFoundError(
            f"MAA found no frames under {images_dir} for the requested "
            f"sequences — check --data-dir and the dataset layout")
    return float(np.mean(values))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Motion-appearance alignment channel election")
    parser.add_argument("--pretrain_dir", type=str, required=True)
    parser.add_argument("--first-frames-only", action="store_true")
    parser.add_argument("--num-channels", type=int, default=4)
    parser.add_argument("--object-channel", type=int, default=None)
    parser.add_argument("--dataset", type=str, default="davis", choices=list(VAL_SEQS))
    parser.add_argument("--step", type=int, default=0)
    parser.add_argument("--export-dir-name", type=str, default="saved_eval_export")
    parser.add_argument("--data-dir", type=str, default="data")
    parser.add_argument("--dino-checkpoint", type=str, default=None)
    parser.add_argument("--seqs", type=str, default=None,
                        help="comma-separated sequence names to elect over "
                             "(default: the reference's hard-coded val list, "
                             "maa.py:319-356; needed for synthetic datasets)")
    return parser.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    """Returns the elected channel (the process's exit code)."""
    args = parse_args(argv)
    set_loglevel(True)
    data_root, images_sub = DATA_ROOTS[args.dataset]
    images_dir = os.path.join(args.data_dir, os.path.basename(data_root), images_sub)
    gt_dir = images_dir.replace("JPEGImages", "Annotations") if args.dataset == "fbms59" else None
    pred_dir = os.path.join(args.pretrain_dir, args.export_dir_name)

    dino = DinoFeatures(checkpoint=args.dino_checkpoint, device=device)
    channels = ([args.object_channel] if args.object_channel is not None
                else list(range(args.num_channels)))
    seqs = args.seqs.split(",") if args.seqs else VAL_SEQS[args.dataset]
    maas = []
    for ch in channels:
        maa = maa_for_channel(dino, images_dir, pred_dir, ch, seqs, args.step,
                              args.first_frames_only, gt_dir)
        logger.info(f"frame MAA with object channel {ch}: {maa * 100.:.2f}")
        maas.append(maa)
    best = channels[int(np.argmax(maas))]
    logger.info(f"The best object channel among all channels evaluated is channel {best}")
    return best  # the reference's contract: the elected channel is the exit code


if __name__ == "__main__":
    sys.exit(main())
