"""Run metrics: a JSONL file and an optional torch.profiler trace (port of
``rcf_tpu/train/metrics.py``).

* every logged step/epoch metric is appended to
  ``<checkpoints_dir>/metrics.jsonl``;
* ``tpu.profile_dir`` in the config captures a ``torch.profiler`` trace
  (CPU and CUDA activity) of steps [profile_start, profile_start +
  profile_steps), written there as a Chrome trace.
"""

from __future__ import annotations

import json
import os
import time

import torch


class MetricsLogger:
    """Appends records to ``<ckpt_dir>/metrics.jsonl``; a no-op with ``ckpt_dir=None``
    (every rank but the first)."""

    def __init__(self, ckpt_dir: str | None):
        self.path = os.path.join(ckpt_dir, "metrics.jsonl") if ckpt_dir else None
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)

    def log(self, **metrics) -> None:
        if self.path is None:
            return
        record = {"ts": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


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
