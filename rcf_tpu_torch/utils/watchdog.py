"""Liveness heartbeat (port of ``rcf_tpu/utils/watchdog.py``'s ``Heartbeat``).

An own copy of the JAX package's heartbeat (stdlib only). The training
loop writes a beat at every point that proves forward progress (step done,
loss read, eval batch done, checkpoint saved); each beat carries a grace,
how long silence after it is still normal, so an outside monitor can kill
a stalled run and the loop's auto-resume then continues from ``last``.
Beats carry a longer grace before a compile-shaped wait (the first step:
cuDNN's autotuning and the kernels' first build) and before a checkpoint
save.

The heartbeat file lives at ``<checkpoints_dir>/.heartbeat`` and contains
the grace (seconds, ASCII float); liveness time is the file's mtime.
"""

from __future__ import annotations

import os

# Silence longer than this after a steady-state beat means stalled. Normal
# gaps it must cover: a checkpoint save, a val epoch, a handful of train
# steps (~100 ms each) -- 15 min is >10x any of them.
DEFAULT_GRACE_S = 900.0
# Grace for beats placed just before a compile-shaped wait (the first step
# of a program: autotuning, the kernels' first build).
COMPILE_GRACE_S = 2400.0
# Grace for the beat just before a checkpoint save.
CKPT_GRACE_S = 420.0

_HB_NAME = ".heartbeat"


class Heartbeat:
    """Writes liveness beats to ``<dir_path>/.heartbeat``; a no-op when
    constructed with dir_path=None."""

    def __init__(self, dir_path: str | None):
        self.path = os.path.join(dir_path, _HB_NAME) if dir_path else None

    def beat(self, grace: float = DEFAULT_GRACE_S) -> None:
        if self.path is None:
            return
        try:
            # "tmp_" prefix (not a ".tmp" suffix) keeps the rename scratch
            # out of a monitor's `.heartbeat*` glob.
            tmp = os.path.join(os.path.dirname(self.path),
                               "tmp_" + os.path.basename(self.path))
            with open(tmp, "w") as f:
                f.write(f"{grace:.1f}")
            os.replace(tmp, self.path)  # atomic: a monitor never reads partial
        except OSError:
            pass  # liveness reporting must never take the run down
