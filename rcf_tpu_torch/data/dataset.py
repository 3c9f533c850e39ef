"""Video-frame dataset over split files (port of ``rcf_tpu/data/dataset.py``).

Frames, annotations and pseudo-labels are decoded by the port's own codec
(``data/image_io.py``), which gives what PIL gives. As in the JAX package
and the reference's `dataset/data.py`:

* split txt lines: ``<seq_dir>/ frame0.jpg frame1.jpg ...`` (sorted);
* one flat index space over the concatenated per-sequence frame lists
  (cumsum + digitize, `dataset/data.py:70-81`); indices within the last
  ``frame_num - 1`` frames of a sequence shift back so a full window fits;
* per-frame RAFT flow loaded from ``Flows<suffix>`` / ``BackwardFlows<suffix>``
  siblings of ``JPEGImages`` with ``.npy`` extension, where flow file ``i``
  holds the flow between frames ``i-1`` and ``i`` (`dataset/data.py:114-133`);
* eval-time annotation from the ``Annotations`` sibling (or a zero stub);
* stage-2.2 pseudo-labels from ``pl_root/pred_seg_{seq}_{frame}_0000000.png``.

Samples come back as numpy arrays in a dict; all augmentation happens in
`transforms.py` with an explicit per-sample RNG (reproducible, worker-safe).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .image_io import read_image


def parse_split(root: str, split: str, subsample_frame_interval: int | None = None):
    """Parse a split file into (seq_names, per-seq frame path lists)."""
    with open(os.path.join(root, split), "r") as f:
        lines = sorted(f.readlines())
    seq_names, seq_paths = [], []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        seq_dir, frames = parts[0], parts[1:]
        if subsample_frame_interval == -1:
            frames = frames[:1]
        elif subsample_frame_interval is not None:
            frames = frames[::subsample_frame_interval]
        seq_names.append(seq_dir.rstrip("/").split("/")[-1])
        seq_paths.append([os.path.join(root, seq_dir, fn) for fn in frames])
    return seq_names, seq_paths


def _load_image(path: str, mode: str = "RGB") -> np.ndarray:
    return read_image(path, mode)


@dataclass
class VideoDataset:
    root: str
    split: str
    training: bool
    frame_num: int = 2
    load_flow: bool = False
    load_pl: bool = False
    subsample_frame_interval: int | None = None
    flow_suffix: str = ""
    zero_ann: bool = False
    pl_root: str | None = None

    seq_names: list = field(init=False)
    seq_paths: list = field(init=False)

    def __post_init__(self):
        if self.subsample_frame_interval is not None and self.training:
            raise ValueError("frame subsampling is eval-only")
        if not self.training and self.frame_num != 1:
            raise ValueError("evaluation uses single frames")
        self.seq_names, self.seq_paths = parse_split(
            self.root, self.split, self.subsample_frame_interval
        )
        self.seq_lens = np.array([len(p) for p in self.seq_paths])
        self.len_cumsum = np.insert(np.cumsum(self.seq_lens), 0, 0)

    def __len__(self) -> int:
        return int(self.seq_lens.sum())

    def __getitem__(self, index: int) -> dict:
        seq_idx = int(np.digitize(index, self.len_cumsum)) - 1
        frame_idx = int(index - self.len_cumsum[seq_idx])
        # Shift back so [frame_idx, frame_idx + frame_num) fits in the sequence.
        overhang = frame_idx - (int(self.seq_lens[seq_idx]) - self.frame_num)
        if overhang > 0:  # training only: eval windows are one frame
            frame_idx -= self.frame_num - 1

        paths = self.seq_paths[seq_idx][frame_idx : frame_idx + self.frame_num]
        sample = {
            "imgs": [_load_image(p) for p in paths],
            "seq_ids": seq_idx,
            "seq_names": self.seq_names[seq_idx],
            "paths": paths,
            "frame_ind_start": frame_idx,
            "seg_fields": [],
        }

        if not self.training:
            if self.zero_ann:
                sample["ann"] = np.zeros((1, 1), np.uint8)
            else:
                ann_path = paths[0].replace("JPEGImages", "Annotations")
                ann_path = os.path.splitext(ann_path)[0] + ".png"
                # Annotations may be RGB or palette PNGs; keep first channel.
                ann = _load_image(ann_path)
                sample["ann"] = ann[..., 0] if ann.ndim == 3 else ann

        if self.load_flow:
            fw, bw = [], []
            for i in range(1, self.frame_num):
                stem = os.path.splitext(paths[i])[0] + ".npy"
                fw.append(np.load(stem.replace("JPEGImages", "Flows" + self.flow_suffix)))
                bw.append(np.load(stem.replace("JPEGImages", "BackwardFlows" + self.flow_suffix)))
            sample["gt_fw_flows"] = fw
            sample["gt_bw_flows"] = bw
            sample["seg_fields"] += ["gt_fw_flows", "gt_bw_flows"]

        if self.load_pl:
            if self.pl_root is None:
                raise ValueError("load_pl requires pl_root")
            pls = []
            for p in paths:
                frame = os.path.splitext(os.path.basename(p))[0]
                pl_path = os.path.join(
                    self.pl_root, f"pred_seg_{sample['seq_names']}_{frame}_0000000.png"
                )
                pls.append(_load_image(pl_path, mode="L"))
            sample["pl_masks"] = pls
            sample["seg_fields"].append("pl_masks")

        return sample
