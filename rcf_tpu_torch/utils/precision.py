"""Full-f32 products on the card: TF32 off for a block, restored after it.

cuDNN takes TF32 for f32 convolutions by default, and a caller may have
switched it on for matmuls. The stage-2 tools threshold products
(``f̂ f̂ᵀ > 0.2`` in the NCut affinity), where TF32's ~1e-3 error flips
pairs near the threshold, so they run inside ``full_f32()``. The switches
are global to the process; the tools' threads share them, so the first
block to enter saves and clears them and the last to leave restores them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0
_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def full_f32():
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _saved
