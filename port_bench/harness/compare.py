"""The numbers that decide ``correct``, each against its limit.

A training cell's set-up drives the program's state through its first three
steps; the reference follows the same three steps from the same weights on
the same batches (the same dropout draws) once the window has closed. The
numbers, each a worst case:

* ``loss.stepK``: |program's loss - reference's| / |reference's| of step K;
* ``logits.step1``: the mask head's logits of the first step (the timed
  path's, caught by a forward hook), |program's - reference's| / |reference's|
  over all of them; ``ema_logits.step1`` the same of the EMA copies' logits
  in eval mode that stage 2.1's CRF target starts from;
* ``grad.worst_leaf``: the first gradient as Adam takes it (the L2 term in
  it), from the program's first moment after step 1 (``exp_avg / (1 -
  beta1)``): per leaf, |norm(program) - norm(reference)| / max(norm of the
  reference's leaf, the median leaf's norm);
* ``change.worst_leaf``: the same of each parameter's change over the three
  steps;
* ``ema.worst_leaf`` (where the recipe has the EMA): the same of the EMA
  copies' change over the three steps;
* ``crf_target.step1`` (where the recipe has the CRF target): the share of
  the first step's CRF answer that differs from the reference's, the mean
  of |program's - reference's| over every pixel of every frame (the answers
  are 0/1 maps resized back to frame size), the reference's made on the
  same frames and the same object masks (the program's, from the EMA
  copies that ``ema_logits.step1`` checks), so that it holds the mean field
  and ``crf_filter`` alone;
* a feed's readings of its own (``runners/train_step.py``).

Each gap of leaf norms is read at the worst leaf and at the median leaf
(``*.worst_leaf``, ``*.median_leaf``); the numbers compared are those the
cell's workload file gives a limit, the others are printed beside them.

Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding) are left out of ``grad`` and ``change``.
"""

from __future__ import annotations

import math

EXCLUDE_BELOW = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list[float]:
    """Each leaf's |norm(program) - norm(reference)| / max(its norm, the median leaf's), sorted."""
    names = [n for n in ref if keep is None or n in keep]
    norms = sorted(ref[n] for n in names)
    median = norms[len(norms) // 2] if norms else 0.0
    return sorted(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names)


def _worst_and_median(gaps: list[float]) -> tuple[float, float]:
    if not gaps:
        return float("nan"), float("nan")
    return gaps[-1], gaps[len(gaps) // 2]


def worst_leaves(prog: dict, ref: dict, keep: set, n: int = 3) -> list:
    """The ``n`` leaves of the largest gap, as (gap, name)."""
    norms = sorted(ref[k] for k in keep)
    median = norms[len(norms) // 2]
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30), k) for k in keep), reverse=True)[:n]


def kept_leaves(ref_grad: dict) -> set:
    norms = sorted(ref_grad.values())
    median = norms[len(norms) // 2]
    return {n for n, v in ref_grad.items() if v >= EXCLUDE_BELOW * median}


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [3 floats], "grad": {leaf: norm}, "change": {...}, "ema": {...},
    "logits": tensor, "ema_logits": tensor or None, "crf": the program's caught (frames,
    masks, answer) / the reference's answer, or None}."""
    out = {}
    for k, (a, b) in enumerate(zip(prog["losses"], ref["losses"]), start=1):
        out[f"loss.step{k}"] = abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else float("inf")
    for key in ("logits", "ema_logits"):
        a, b = prog.get(key), ref.get(key)
        if b is not None:
            same = a is not None and tuple(a.shape) == tuple(b.shape)
            out[f"{key}.step1"] = float((a - b).norm() / b.norm()) if same else float("inf")
    if ref.get("crf") is not None:
        got = prog["crf"][2] if prog.get("crf") is not None else None
        same = got is not None and tuple(got.shape) == tuple(ref["crf"].shape)
        out["crf_target.step1"] = float((got - ref["crf"]).abs().mean()) if same else float("inf")
    keep = kept_leaves(ref["grad"])
    for key in ("grad", "change", "ema"):
        if ref.get(key):
            worst, median = _worst_and_median(leaf_gaps(prog[key], ref[key], keep if key != "ema" else None))
            out[f"{key}.worst_leaf"], out[f"{key}.median_leaf"] = worst, median
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number finite and within its limit, {name: {value, limit}}).
    The numbers compared are those the cell's workload file gives a limit."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for {sorted(missing)}")
    table, ok = {}, True
    for name in limits:
        value = numbers[name]
        table[name] = {"value": value, "limit": limits[name]}
        ok = ok and math.isfinite(value) and value <= limits[name]
    return ok, table
