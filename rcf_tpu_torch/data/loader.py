"""Host data loader: sharded, shuffled, threaded, prefetching (port of
``rcf_tpu/data/loader.py``).

The same index plans as the JAX package's loader: a ``default_rng((seed,
epoch))`` permutation, wrap-padded per shard and then to whole batches
(static batch shapes, PARITY deviation 4); each sample augmented with its
own ``default_rng((seed, epoch, index))``; eval batches grouped by the
source frame size (read from the file header), so that a variable-aspect
set makes a few shapes. A thread pool decodes and augments (the codec's
ctypes calls and numpy release the GIL) and a small queue prefetches.

Batches are torch tensors. With ``pin_memory`` each batch is collated in
the producer thread into fresh page-locked tensors, so the training loop
copies it to the card with ``non_blocking=True``; no buffer is reused, so
none is overwritten while its copy is in flight.

Over several ranks the training loop passes the rank as ``shard_index``
and the world size as ``num_shards``: rank ``r`` takes ``padded[r::world]``
of the epoch's plan, so its local sample ``j`` of a step is the global
sample ``j * world + r``, the plan ``parallel/dist.py::local_rows`` relies
on to draw dropout for the whole batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from .image_io import image_size

_STACK_KEYS = ("imgs", "gt_fw_flows", "gt_bw_flows", "pl_masks", "ann")
_LIST_KEYS = ("seq_names", "paths", "frame_ind_start")


def collate(samples: list[dict], pin_memory: bool = False) -> dict:
    """Stack the samples' arrays into (pinned) tensors; names and paths stay lists."""
    batch: dict = {}
    for key in _STACK_KEYS:
        if key in samples[0]:
            first = np.asarray(samples[0][key])
            out = torch.empty((len(samples), *first.shape),
                              dtype=torch.from_numpy(first[:0].copy()).dtype,
                              pin_memory=pin_memory)
            view = out.numpy()
            for i, s in enumerate(samples):
                view[i] = s[key]
            batch[key] = out
    batch["seq_ids"] = torch.tensor([s["seq_ids"] for s in samples], dtype=torch.int32)
    for key in _LIST_KEYS:
        if key in samples[0]:
            batch[key] = [s[key] for s in samples]
    return batch


class DataLoader:
    def __init__(
        self,
        dataset,
        transform,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        num_workers: int = 8,
        shard_index: int = 0,
        num_shards: int = 1,
        drop_last: bool | None = None,
        group_by_shape: bool = False,
        prefetch: int = 2,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.drop_last = shuffle if drop_last is None else drop_last
        self.group_by_shape = group_by_shape
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    # -- index plan ------------------------------------------------------
    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(n)
            # Equal per-shard length (wrap-pad like DistributedSampler).
            per_shard = -(-n // self.num_shards)
            padded = np.concatenate([order, order[: per_shard * self.num_shards - n]])
            mine = padded[self.shard_index :: self.num_shards]
            # Wrap-pad to a whole number of batches (static batch shapes).
            remainder = len(mine) % self.batch_size
            if remainder:
                mine = np.concatenate([mine, mine[: self.batch_size - remainder]])
            return mine
        return np.arange(n)[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # -- iteration ---------------------------------------------------------
    def _load_one(self, index: int) -> dict:
        with record_function("rcf.data.sample"):
            sample = self.dataset[int(index)]
            rng = np.random.default_rng((self.seed, self.epoch, int(index)))
            return self.transform(sample, rng)

    def batches_of_indices(self):
        """The epoch's batches as arrays of dataset indices."""
        indices = self._epoch_indices()
        if not self.group_by_shape:
            end = len(indices) - (len(indices) % self.batch_size) if self.drop_last else len(indices)
            for i in range(0, end, self.batch_size):
                yield indices[i : i + self.batch_size]
            return
        # Shape-grouped (eval): bucket consecutive samples by source frame size.
        buckets: dict[tuple, list[int]] = {}
        probe_cache: dict[str, tuple] = {}
        for idx in indices:
            shape = self._probe_shape(int(idx), probe_cache)
            bucket = buckets.setdefault(shape, [])
            bucket.append(int(idx))
            if len(bucket) == self.batch_size:
                yield np.array(bucket)
                bucket.clear()
        for bucket in buckets.values():
            if bucket:
                yield np.array(bucket)

    def _probe_shape(self, index: int, cache: dict) -> tuple:
        seq_idx = int(np.digitize(index, self.dataset.len_cumsum)) - 1
        path = self.dataset.seq_paths[seq_idx][0]
        key = path.rsplit("/", 2)[0] + "/" + self.dataset.seq_names[seq_idx]
        if key not in cache:
            cache[key] = image_size(path)  # (W, H)
        return cache[key]

    def __iter__(self):
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                # workers: 0 (load in the main process, as the reference) still
                # needs one pool thread here.
                with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
                    for batch_idx in self.batches_of_indices():
                        samples = list(pool.map(self._load_one, batch_idx))
                        with record_function("rcf.data.collate"):
                            batch = collate(samples, self.pin_memory)
                        if not put(batch):
                            return
            except Exception as exc:  # handed to the consumer, raised there
                put(exc)
                return
            put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)
