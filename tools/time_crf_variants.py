#!/usr/bin/env python3
"""Time design variants of ``crf_filter`` (``rcf_tpu_torch/csrc/crf.cu``) in turns on one card.

    python3 tools/time_crf_variants.py [--baseline NAME=DIR ...] [--variants a,b,...] [--rounds 2]

Builds every variant of ``VARIANTS`` (text replacements in a copy of
``crf.cu``, ``crf_kernels.build_patched``; ``release`` is the source as it
is) and, for each ``--baseline``, the ``crf.cu`` of another source directory
(an earlier design, e.g. ``git show <rev>:rcf_tpu_torch/csrc/crf.cu`` written
into a directory under the gitignored ``rcf_tpu_torch/build/``), one nvcc
each, side by side. For each library it prints the registers, spills and
shared memory of each instance (``cuda_build.ptxas_entries``) and the worst
error against ``crf_filter_plain`` and against a float64 filter on
``chip_smoke``'s five kernel sets (``crf_filter_sets``, TF32 on, limits
``CRF_TOL``). Then it times each at the DAVIS grid (16 x 96^2, D = 5) and
the SegTrackv2 grid (16 x 128^2): device time on inputs the L2 does not
hold (``chip_smoke.graph_ms`` over ``cold_sets``), in turns (baseline, the
variants, then the same in reverse), ``--rounds`` times, each reading
beside the bound (``chip_smoke.crf_bound``). Last, one JSON line with the
card's name and power limit. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Replacements in crf.cu (each old text occurs exactly once), composed into
# VARIANTS. The diagnostics compute another function (they fail the accuracy
# check): each takes one unit's work away, to show what the time is made of.
def _set(name: str, old: int, new: int) -> tuple:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


W4, T1, T4 = _set("kWarps", 8, 4), _set("kTiles", 2, 1), _set("kTiles", 2, 4)
NO_MIN_BLOCKS = ("__launch_bounds__(kThreads, kMinBlocks)", "__launch_bounds__(kThreads)")
LO = "#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_lo[m], bh0, bh1);\n"
HI = "#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bh0, bh1);\n"
HI_LO = "#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bl0, bl1);\n"
# The stage's key loop, software-pipelined: the next group's products issued
# before this group's ex2.
PIPELINED = """    float acc0[kTiles][4], acc1[kTiles][4];
    logits(acc0, s_key[buf][0][lane]);
#pragma unroll
    for (int grp = 0; grp < kKeys / 8; grp += 2) {
      logits(acc1, s_key[buf][grp + 1][lane]);
      accumulate(acc0, val[4 * grp]);
      if (grp + 2 < kKeys / 8) logits(acc0, s_key[buf][grp + 2][lane]);
      accumulate(acc1, val[4 * grp + 4]);
    }
"""
# The same without the pipelining: each group's products, then its ex2.
PLAIN_LOOP = """#pragma unroll 4
    for (int grp = 0; grp < kKeys / 8; ++grp) {
      float acc[kTiles][4];
      logits(acc, s_key[buf][grp][lane]);
      accumulate(acc, val[4 * grp]);
    }
"""
VARIANTS = {
    "release": [],
    "no_min_blocks": [NO_MIN_BLOCKS],
    "plain_loop": [(PIPELINED, PLAIN_LOOP)],
    "plain_loop_no_min_blocks": [(PIPELINED, PLAIN_LOOP), NO_MIN_BLOCKS],
    "warps4_tiles4": [W4, T4],
    "warps4_tiles4_plain_loop": [W4, T4, (PIPELINED, PLAIN_LOOP)],
    "warps4": [W4],
    "tiles1": [T1],
    "unroll_2": [(PIPELINED, PIPELINED.replace("#pragma unroll\n", "#pragma unroll 2\n"))],
    # The fourth product lo.lo: what the dropped term costs and buys.
    "lolo": [(LO, LO.replace("bh0, bh1", "bl0, bl1") + LO)],
    # Diagnostics: one TF32 product instead of three; no mma (an FMUL a logit);
    # no ex2 (w = the logit).
    "diag_one_product": [(LO, ""), (HI_LO, "")],
    "diag_no_mma": [(LO, ""), (HI_LO, ""), (HI, HI.replace(
        "mma_tf32(acc[m], a_hi[m], bh0, bh1);",
        "\n      for (int e = 0; e < 4; ++e) acc[m][e] = __uint_as_float(a_hi[m][e]) * __uint_as_float(bh0);"))],
    "diag_no_ex2": [("  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));", "  y = x;")],
}
# SASS opcodes counted in each kernel instance (the loop's units).
OPCODES = ("HMMA", "MUFU.EX2", "FFMA", "FADD", "LDS", "STS", "BAR")
GRIDS = (("davis", 96, 0.25), ("stv2", 128, 1 / 3))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=DIR: a source directory holding another crf.cu (repeatable)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass-dir", help="write each library's SASS (cuobjdump -sass) here")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from rcf_tpu_torch.ops import crf as crf_ops
    from rcf_tpu_torch.ops import crf_kernels as ck
    from rcf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        jobs = {n: pool.submit(ck.build_patched, VARIANTS[n], f"crf_{n}") for n in names}
        bases = dict(b.split("=", 1) for b in args.baseline)
        jobs = {**{n: pool.submit(ck.build, os.path.abspath(d)) for n, d in bases.items()}, **jobs}
        sos = {}
        for n, j in jobs.items():
            try:
                sos[n] = j.result()
            except RuntimeError as e:  # a variant the compiler refuses is reported, not timed
                print(f"{n}: build failed: {e}", flush=True)
    if not sos:
        return 1
    libs = {n: ck.load_library(so) for n, so in sos.items()}
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
    sets = cs.crf_filter_sets(torch, crf_ops, torch.Generator(device="cuda").manual_seed(4))
    refs = {k: (ck.crf_filter_plain(f, v), cs.crf_filter_f64(torch, f, v))
            for k, (f, v) in sets.items()}
    for n, lib in libs.items():
        ck._lib = lib
        errs = {}
        for k, (f, v) in sets.items():
            out = ck.crf_filter(f, v)
            errs[k] = (cs.max_err(out, refs[k][0]), cs.max_err(out, refs[k][1]))
        report[n]["max_abs_err"] = errs
        bad = [k for k, e in errs.items() if not max(e) <= cs.CRF_TOL[k]]
        report[n]["within_tol"] = not bad
        print(f"{n:20s} max_abs_err (plain, float64): "
              + ", ".join(f"{k} {a:.2e} {b:.2e}" for k, (a, b) in errs.items())
              + (f"  OVER CRF_TOL on {bad}" if bad else ""), flush=True)
    del sets, refs

    order = list(libs)
    turns = (order + order[::-1]) * args.rounds
    gen = torch.Generator(device="cuda").manual_seed(5)
    for grid, hw, scale in GRIDS:
        def make():
            f = cs.crf_features(torch, crf_ops, gen, 16, hw, hw, scale)
            return f, torch.rand(f.shape[:2], generator=gen, device="cuda")
        first = make()
        inputs = [first] + [make() for _ in range(cs.cold_sets(cs.nbytes(*first, first[1])) - 1)]
        fns = [lambda f=f, v=v: ck.crf_filter(f, v) for f, v in inputs]
        bound_ms = cs.crf_bound(16, hw * hw, 5)[0]
        # The SM clock and the power while the turns run, every 100 ms.
        smi_log = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                    "--format=csv,noheader,nounits", "-lms", "100"],
                                   stdout=subprocess.PIPE, text=True)
        for n in turns:
            ck._lib = libs[n]
            ms = cs.graph_ms(torch, fns, iters=50)
            report[n].setdefault(f"ms_{grid}", []).append(ms)
            print(f"{grid:5s} {n:20s} {ms:.4f} ms device ({bound_ms / ms:.0%} of the bound "
                  f"{bound_ms:.4f} ms)", flush=True)
        smi_log.terminate()
        samples = [[float(x) for x in ln.split(",")] for ln in smi_log.communicate()[0].splitlines()
                   if ln.count(",") == 1]
        clocks = sorted(c for c, _ in samples)
        if clocks:
            print(f"{grid:5s} SM clock while timing: {clocks[0]:.0f}-{clocks[-1]:.0f} MHz "
                  f"(median {clocks[len(clocks) // 2]:.0f}, {len(clocks)} samples), power up to "
                  f"{max(p for _, p in samples):.0f} W", flush=True)
        del inputs, fns
    ck._lib = None
    print(json.dumps({"device": smi, "variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
