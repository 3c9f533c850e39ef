"""Run metrics: a JSONL file, an optional torch.profiler trace (port of
``rcf_tpu/train/metrics.py``), and the catalogue of the port's named spans.

* every train step, and every logged epoch and evaluation metric, is
  appended to ``<checkpoints_dir>/metrics.jsonl``; a step's record waits in
  memory, with the CUDA events around its step, until the loop reads a loss
  (``flush``), so that recording a step adds no synchronisation and no
  file write;
* ``tpu.profile_dir`` in the config captures a ``torch.profiler`` trace
  (CPU and CUDA activity) of steps [profile_start, profile_start +
  profile_steps), written there as a Chrome trace.

Spans are ``torch.profiler.record_function`` ranges. With no profiler
running each costs one enter and exit; under a profiler with the CPU
activity they land in the same trace as the kernels, on one clock, so a
kernel belongs to the spans that hold the runtime call that launched it
(``tools/span_breakdown.py``). None sits inside a model module, and none is
entered once a mean-field iteration (the flag read is once a host sync).
The whole catalogue (``SPANS``):

==============================  ==============================================
Span                            Where
==============================  ==============================================
``rcf.step``                    ``train/step.py::train_step``, the whole call
``rcf.step.crf_target``         ``_crf_targets`` (stage 2.1)
``rcf.crf_target.ema_forward``  the EMA copies' ``mask_probs`` under ``_eval_mode``
``rcf.crf.prepare``             ``ops/crf.py::make_crf_fn``'s ``prepare``: uint8, resizes
``rcf.crf.mean_field``          ``ops/crf.py::mean_field``, all iterations as one span
``rcf.crf.flag_read``           the stable exit's ``bool(done.all())``, one a host sync
``rcf.step.forward``            ``model(**batch)``, the losses included
``rcf.step.backward``           ``losses["loss"].backward()``
``rcf.step.update``             gradient all-reduce, learning rate, Adam, the EMA
``rcf.step.grad_allreduce``     inside ``rcf.step.update``
``rcf.step.optimizer``          inside ``rcf.step.update``
``rcf.step.ema_update``         inside ``rcf.step.update``
``rcf.dist.<collective>``       each public collective of ``parallel/dist.py``
                                past its one-rank return (``DIST_SPANS``)
``rcf.loop.loader_wait``        ``train/loop.py``: ``next(batches)``
``rcf.loop.to_device``          ``train/loop.py``: ``_step_batch``
``rcf.loop.log``                ``train/loop.py``: the loss read, the loop's host sync
``rcf.loop.visualize``          ``train/loop.py``: the train grid
``rcf.loop.eval``               ``train/loop.py::evaluate``
``rcf.loop.checkpoint``         ``train/loop.py``: top-k or ``last`` save
``rcf.data.sample``             ``data/loader.py``: one sample, in a worker thread
``rcf.data.collate``            ``data/loader.py``: one batch, in the producer thread
``rcf.dino.forward``            ``grouping/pipeline.py::DinoFeatures``: the ViT's
                                normalisation, resize and forward
``rcf.dino.attention``          inside ``rcf.dino.forward``: one a block that runs
                                attention (product, softmax, product)
``rcf.ncut.affinity``           ``grouping/ncut.py::build_affinity``
``rcf.ncut.refine``             ``grouping/ncut.py::ncut_refine``: the Adam steps
==============================  ==============================================

Counters: ``ops/crf.py::STATS`` (mean-field iterations, host syncs),
``parallel/dist.py::STATS`` (calls and payload bytes of each collective
kind) and ``grouping.STATS`` (the semantic constraint's frames, tokens,
attention pairs and NCut steps), each with ``reset_stats()``; a step's
record holds its deltas of the first two (``crf_<key>``, ``dist_<key>``).
"""

from __future__ import annotations

import json
import os
import time

import torch

DIST_SPANS = tuple(f"rcf.dist.{name}" for name in (
    "all_reduce_mean", "all_reduce_sum", "all_reduce_max", "mean_losses", "global_ratio",
    "broadcast", "broadcast_state", "gather_rows", "barrier"))
SPANS = ("rcf.step", "rcf.step.crf_target", "rcf.crf_target.ema_forward", "rcf.crf.prepare",
         "rcf.crf.mean_field", "rcf.crf.flag_read", "rcf.step.forward", "rcf.step.backward",
         "rcf.step.update", "rcf.step.grad_allreduce", "rcf.step.optimizer",
         "rcf.step.ema_update") + DIST_SPANS + (
         "rcf.loop.loader_wait", "rcf.loop.to_device", "rcf.loop.log", "rcf.loop.visualize",
         "rcf.loop.eval", "rcf.loop.checkpoint", "rcf.data.sample", "rcf.data.collate",
         "rcf.dino.forward", "rcf.dino.attention", "rcf.ncut.affinity", "rcf.ncut.refine")


class MetricsLogger:
    """Appends records to ``<ckpt_dir>/metrics.jsonl``; a no-op with ``ckpt_dir=None``
    (every rank but the first)."""

    def __init__(self, ckpt_dir: str | None):
        self.path = os.path.join(ckpt_dir, "metrics.jsonl") if ckpt_dir else None
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
        self._steps: list = []

    def step(self, record: dict, events: tuple | None) -> None:
        """Keep one step's record until ``flush``, which adds its ``step_device_s``
        from ``events`` (CUDA events recorded before and after the step; None on
        the CPU, where it stays null)."""
        if self.path is not None:
            self._steps.append(({"ts": time.time(), **record, "step_device_s": None}, events))

    def flush(self) -> None:
        """Write the kept step records. Waits for the last step's end event, which
        the caller's loss read has already waited for."""
        if not self._steps:
            return
        last = self._steps[-1][1]
        if last is not None:
            last[1].synchronize()
        for record, events in self._steps:
            if events is not None:
                record["step_device_s"] = events[0].elapsed_time(events[1]) * 1e-3
        self._write([record for record, _ in self._steps])
        self._steps = []

    def log(self, **metrics) -> None:
        if self.path is None:
            return
        self.flush()
        self._write([{"ts": time.time(), **metrics}])

    def _write(self, records: list) -> None:
        with open(self.path, "a") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))


class StepProfiler:
    """Trace steps [start, start+steps) with torch.profiler."""

    def __init__(self, profile_dir: str | None, start: int = 10, steps: int = 5):
        self.profile_dir = profile_dir
        self.start = start
        self.stop = start + steps
        self._prof = None
        self._first = start

    def maybe_start(self, step: int) -> None:
        # A window test, not equality: a resumed run may start past ``start``.
        if self.profile_dir and self._prof is None and self.start <= step < self.stop:
            os.makedirs(self.profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self._first = step

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(os.path.join(
                self.profile_dir, f"trace_steps{self._first}-{step - 1}.json"))
            self._prof = None
