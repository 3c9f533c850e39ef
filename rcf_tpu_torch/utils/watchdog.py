"""Liveness heartbeat and a supervising monitor (port of ``rcf_tpu/utils/watchdog.py``).

An own copy of the JAX package's module (stdlib only). Two halves:

* ``Heartbeat``: the training loop writes a beat at every point that
  proves forward progress (step done, loss read, eval batch done,
  checkpoint saved); each beat carries a grace, how long silence after it
  is still normal. Beats carry a longer grace before a compile-shaped wait
  (the first step: cuDNN's autotuning and the kernels' first build) and
  before a checkpoint save.
* ``supervise``: run a command under a monitor that kills it when a
  heartbeat goes silent past its grace, so that a caller can retry the
  stage (the loop's auto-resume continues from ``last``).

Each rank writes its own file: rank 0 ``<checkpoints_dir>/.heartbeat``,
rank i ``.heartbeat.h<i>``; the run is stalled when any of them is. A file
holds the grace (seconds, ASCII float); liveness time is its mtime. A file
older than the supervised process counts as absent (stale from an earlier
run).
"""

from __future__ import annotations

import glob as globlib
import os
import subprocess
import time

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
    """Writes liveness beats to ``<dir_path>/.heartbeat`` (rank ``host`` > 0:
    ``.heartbeat.h<host>``); a no-op when constructed with dir_path=None or
    enabled=False."""

    def __init__(self, dir_path: str | None, enabled: bool = True, host: int = 0):
        name = _HB_NAME if host == 0 else f"{_HB_NAME}.h{host}"
        self.path = os.path.join(dir_path, name) if dir_path else None
        self.enabled = enabled and self.path is not None

    def beat(self, grace: float = DEFAULT_GRACE_S) -> None:
        if not self.enabled:
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


def _all_heartbeat_files(hb_path: str) -> list[str]:
    """hb_path plus the other ranks' files (.heartbeat.h1, ...)."""
    return [hb_path] + sorted(globlib.glob(hb_path + ".h*"))


def read_heartbeat(hb_path: str, not_before: float) -> tuple[float, float]:
    """Return (last_beat_time, grace). Missing, stale or corrupt files report
    (not_before, COMPILE_GRACE_S): before its first beat the child is in
    its start-up and first-build window."""
    try:
        mtime = os.path.getmtime(hb_path)
        if mtime < not_before:
            return not_before, COMPILE_GRACE_S
        with open(hb_path) as f:
            return mtime, float(f.read().strip() or DEFAULT_GRACE_S)
    except (OSError, ValueError):
        return not_before, COMPILE_GRACE_S


def is_stalled(hb_path: str, started_at: float, now: float | None = None) -> bool:
    """Stalled = any rank's beat file silent past its grace.

    A rank's file that appeared in this run and went quiet is a stall on
    that rank even while rank 0 still beats; the other ranks' files older
    than the run are skipped (stale siblings), rank 0's gets the start-up
    grace (``read_heartbeat``)."""
    now = time.time() if now is None else now
    for path in _all_heartbeat_files(hb_path):
        if path != hb_path:
            try:
                if os.path.getmtime(path) < started_at:
                    continue  # stale sibling from an earlier run
            except OSError:
                continue
        beat_t, grace = read_heartbeat(path, started_at)
        if now - beat_t > grace:
            return True
    return False


def supervise(cmd: list[str], hb_path: str, log_path: str, cwd: str | None = None,
              poll_s: float = 20.0, timeout_s: float | None = None,
              env: dict | None = None) -> tuple[int | None, bool]:
    """Run cmd, killing it if its heartbeat stalls. Returns (rc, stalled);
    rc is None when the monitor killed it. Its stdout and stderr go to
    log_path (a pipe would block the child once full)."""
    started = time.time()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=logf, stderr=subprocess.STDOUT, env=env)
        try:
            while True:
                rc = proc.poll()
                if rc is not None:
                    return rc, False
                now = time.time()
                if timeout_s is not None and now - started > timeout_s:
                    break
                if is_stalled(hb_path, started, now):
                    break
                time.sleep(min(poll_s, 0.5 if poll_s < 1 else poll_s))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return None, True
