#!/usr/bin/env python3
"""Time design variants of ``crf_filter`` (``rcf_tpu_torch/csrc/crf.cu``) in turns on one card.

    python3 tools/time_crf_variants.py [--baseline NAME=DIR ...] [--variants a,b,...] [--rounds 2]

Builds every variant of ``VARIANTS`` (text replacements in a copy of
``crf.cu``, ``crf_kernels.LIB.build_patched``; ``release`` is the source as
it is) and, for each ``--baseline``, the ``crf.cu`` of another source directory
(an earlier design, e.g. ``git show <rev>:rcf_tpu_torch/csrc/crf.cu`` written
into a directory under the gitignored ``rcf_tpu_torch/build/``; one without
the accumulators, the dense design before the tile-pair schedule, is called
through its own signature, ``DenseABI``), one nvcc each, side by side. For each library
it prints the registers, spills and shared memory of each instance
(``cuda_build.ptxas_entries``) and the worst error against
``crf_filter_plain`` and against a float64 filter on the card tests' five
sets (``kernel_sets.crf_filter_sets``, TF32 on, limits ``CRF_TOL``). Then it
times each at ``GRIDS``: the DAVIS grid (16 x 96^2, D = 5), the SegTrackv2
grid (16 x 128^2), the stage-2.1 cell's batch (32 x 128^2) and a 480p frame
(1 x 480 x 854): device time on inputs the L2 does not hold
(``chip_smoke.graph_ms`` over ``cold_sets``), in turns (baseline, the
variants, then the same in reverse), ``--rounds`` times, each reading beside
the dense ex2 floor (``chip_smoke.crf_bound``: B N^2 exponentials) and the
schedule's (``crf_kernels.schedule_pairs`` exponentials). Last, one JSON
line with the card's name and power limit. Needs a CUDA device; imports no
JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

# Replacements in crf.cu (each old text occurs exactly once), composed into
# VARIANTS. The diagnostics compute another function (they fail the accuracy
# check): each takes one unit's work away, to show what the time is made of.
def _set(name: str, old: int, new: int) -> tuple:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


W8, T2 = _set("kWarps", 4, 8), _set("kTiles", 4, 2)
MIN3, MIN2 = _set("kMinBlocks", 4, 3), _set("kMinBlocks", 4, 2)
NO_MIN_BLOCKS = ("__launch_bounds__(kThreads, kMinBlocks)", "__launch_bounds__(kThreads)")
LO = "#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_lo[m], bh0, bh1);\n"
HI = "#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bh0, bh1);\n"
HI_LO = "#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bl0, bl1);\n"
# The pair's group loop, unrolled 4 deep.
GROUP_LOOP = "#pragma unroll 4\n    for (int grp = 0; grp < kGroups - 2; grp += 2) {"
# The key loop, software-pipelined, and the same without the pipelining.
PIPELINED = """    float acc0[kTiles][4], acc1[kTiles][4];
    logits(acc0, s_key[0][lane]);
#pragma unroll 4
    for (int grp = 0; grp < kGroups - 2; grp += 2) {
      logits(acc1, s_key[grp + 1][lane]);
      accumulate(acc0, val[4 * grp], grp, columns);
      logits(acc0, s_key[grp + 2][lane]);
      accumulate(acc1, val[4 * grp + 4], grp + 1, columns);
    }
    logits(acc1, s_key[kGroups - 1][lane]);
    accumulate(acc0, val[4 * (kGroups - 2)], kGroups - 2, columns);
    accumulate(acc1, val[4 * (kGroups - 1)], kGroups - 1, columns);
"""
PLAIN_LOOP = """#pragma unroll 8
    for (int grp = 0; grp < kGroups; ++grp) {
      float acc[kTiles][4];
      logits(acc, s_key[grp][lane]);
      accumulate(acc, val[4 * grp], grp, columns);
    }
"""
# An off-diagonal pair's key loop (with the columns) and its flush to the accumulator.
OFF_DIAGONAL = "        key_loop(std::true_type{});"
COLUMN_FLUSH = "      if (j0 + r < n) red_add2(sb + 2 * (size_t)(j0 + r), cn, cd);\n"
VARIANTS = {
    "release": [],
    "no_min_blocks": [NO_MIN_BLOCKS],
    "min_blocks_3": [MIN3],
    "plain_loop": [(PIPELINED, PLAIN_LOOP)],
    "unroll_2": [(GROUP_LOOP, GROUP_LOOP.replace("unroll 4", "unroll 2"))],
    "unroll_8": [(GROUP_LOOP, GROUP_LOOP.replace("unroll 4", "unroll 8"))],
    "unroll_full": [(GROUP_LOOP, GROUP_LOOP.replace("unroll 4", "unroll"))],
    # 8 warps of 2 row tiles (64 registers a thread, 32 warps an SM).
    "warps8_tiles2": [W8, T2],
    # The fourth product lo.lo: what the dropped term costs and buys.
    "lolo": [(LO, LO.replace("bh0, bh1", "bl0, bl1") + LO)],
    # Diagnostics: one TF32 product instead of three; no mma (an FMUL a logit);
    # no ex2 (w = the logit); no column sums in the key loop (the pairs off
    # the diagonal run the diagonal's loop); no column flush to the accumulator.
    "diag_one_product": [(LO, ""), (HI_LO, "")],
    "diag_no_mma": [(LO, ""), (HI_LO, ""), (HI, HI.replace(
        "mma_tf32(acc[m], a_hi[m], bh0, bh1);",
        "\n      for (int e = 0; e < 4; ++e) acc[m][e] = __uint_as_float(a_hi[m][e]) * __uint_as_float(bh0);"))],
    "diag_no_ex2": [("  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));", "  y = x;")],
    "diag_no_columns": [(OFF_DIAGONAL, OFF_DIAGONAL.replace("true_type", "false_type"))],
    "diag_no_column_flush": [(COLUMN_FLUSH, "")],
}
# SASS opcodes counted in each kernel instance (the loop's units).
OPCODES = ("HMMA", "MUFU.EX2", "FFMA", "FADD", "SHFL", "LDS", "STS", "RED", "BAR")
# name, images, height, width, xy scale (sxy 60 over the grid's scale).
GRIDS = (("davis", 16, 96, 96, 0.25), ("stv2", 16, 128, 128, 1 / 3),
         ("cell", 32, 128, 128, 1 / 3), ("480p", 1, 480, 854, 1.0))


class DenseABI:
    """A library of the dense design (no accumulators), called through the
    current signature: the accumulators' pointers are dropped."""

    def __init__(self, path: str):
        self._lib = ctypes.CDLL(path)
        p = ctypes.c_void_p
        self._lib.rcf_crf_filter.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, p]
        self._lib.rcf_crf_filter.restype = ctypes.c_int

    def rcf_crf_filter(self, feat, values, out, sums, done, b, n, d, stream):
        return self._lib.rcf_crf_filter(feat, values, out, b, n, d, stream)


def load_any(ck, so: str, src_dir: str | None = None):
    """``so`` loaded under the current signature, whichever design built it."""
    if src_dir is not None:
        with open(os.path.join(src_dir, "crf.cu")) as f:
            if "float* sums" not in f.read():
                return DenseABI(so)
    return ck.LIB.load(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=DIR: a source directory holding another crf.cu (repeatable)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--grids", default=",".join(g[0] for g in GRIDS))
    ap.add_argument("--sass-dir", help="write each library's SASS (cuobjdump -sass) here")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    import kernel_sets as ks
    from rcf_tpu_torch.ops import crf_kernels as ck
    from rcf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        jobs = {n: pool.submit(ck.LIB.build_patched, VARIANTS[n], f"crf_{n}") for n in names}
        bases = dict(b.split("=", 1) for b in args.baseline)
        jobs = {**{n: pool.submit(ck.LIB.build, os.path.abspath(d)) for n, d in bases.items()},
                **jobs}
        sos = {}
        for n, j in jobs.items():
            try:
                sos[n] = j.result()
            except RuntimeError as e:  # a variant the compiler refuses is reported, not timed
                print(f"{n}: build failed: {e}", flush=True)
    if not sos:
        return 1
    libs = {n: load_any(ck, so, os.path.abspath(bases[n]) if n in bases else None)
            for n, so in sos.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {smi}", flush=True)
    report = {n: {"ptxas": cuda_build.ptxas_entries(so)} for n, so in sos.items()}
    for n, r in report.items():
        for e in r["ptxas"]:
            print(f"{n:20s} ptxas {e['entry']}: {e.get('registers')} registers, spill "
                  f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes, {e.get('smem')} bytes "
                  f"shared", flush=True)

    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
        for n, so in sos.items():
            sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
            with open(os.path.join(args.sass_dir, f"crf_{n}.sass"), "w") as f:
                f.write(sass)
            for inst in sass.split("Function : ")[1:]:
                counts = {op: sum(f" {op}" in ln for ln in inst.splitlines()) for op in OPCODES}
                report[n].setdefault("sass_counts", {})[inst.split()[0]] = counts
                print(f"{n:14s} sass {inst.split()[0][-40:]}: {counts}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    sets = ks.crf_filter_sets(torch.Generator(device="cuda").manual_seed(4))
    refs = {k: (ck.crf_filter_plain(f, v), ks.crf_filter_f64(f, v)) for k, (f, v) in sets.items()}
    for n, lib in libs.items():
        errs = {}
        with ck.LIB.using(lib):
            for k, (f, v) in sets.items():
                out = ck.crf_filter(f, v)
                errs[k] = (cs.max_err(out, refs[k][0]), cs.max_err(out, refs[k][1]))
        report[n]["max_abs_err"] = errs
        bad = [k for k, e in errs.items() if not max(e) <= ks.CRF_TOL[k]]
        report[n]["within_tol"] = not bad
        print(f"{n:20s} max_abs_err (plain, float64): "
              + ", ".join(f"{k} {a:.2e} {b:.2e}" for k, (a, b) in errs.items())
              + (f"  OVER CRF_TOL on {bad}" if bad else ""), flush=True)
    del sets, refs

    order = list(libs)
    turns = (order + order[::-1]) * args.rounds
    gen = torch.Generator(device="cuda").manual_seed(5)
    for grid, b, h, w, scale in GRIDS:
        if grid not in args.grids.split(","):
            continue
        def make():
            f = ks.crf_features(gen, b, h, w, scale)
            return f, torch.rand(f.shape[:2], generator=gen, device="cuda")
        first = make()
        inputs = [first] + [make() for _ in range(cs.cold_sets(cs.nbytes(*first, first[1])) - 1)]
        fns = [lambda f=f, v=v: ck.crf_filter(f, v) for f, v in inputs]
        dense_ms = cs.crf_bound(b, h * w, 5)[0]
        schedule_ms = ck.schedule_pairs(b, h * w) / cs.EX2_PER_S * 1e3
        iters = 50 if b * (h * w) ** 2 < 1e10 else 5
        # The SM clock and the power while the turns run, every 100 ms.
        smi_log = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                    "--format=csv,noheader,nounits", "-lms", "100"],
                                   stdout=subprocess.PIPE, text=True)
        for n in turns:
            with ck.LIB.using(libs[n]):
                ms = cs.graph_ms(torch, fns, iters=iters, reps=5 if iters > 5 else 2)
            report[n].setdefault(f"ms_{grid}", []).append(ms)
            print(f"{grid:5s} {n:20s} {ms:.4f} ms device ({dense_ms / ms:.0%} of the dense ex2 "
                  f"floor {dense_ms:.4f} ms, {schedule_ms / ms:.0%} of the schedule's "
                  f"{schedule_ms:.4f} ms)", flush=True)
        smi_log.terminate()
        samples = [[float(x) for x in ln.split(",")] for ln in smi_log.communicate()[0].splitlines()
                   if ln.count(",") == 1]
        clocks = sorted(c for c, _ in samples)
        if clocks:
            print(f"{grid:5s} SM clock while timing: {clocks[0]:.0f}-{clocks[-1]:.0f} MHz "
                  f"(median {clocks[len(clocks) // 2]:.0f}, {len(clocks)} samples), power up to "
                  f"{max(p for _, p in samples):.0f} W", flush=True)
        del inputs, fns
    print(json.dumps({"device": smi, "variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
