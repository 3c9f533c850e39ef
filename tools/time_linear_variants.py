#!/usr/bin/env python3
"""Time design variants of ``dino_linear`` (``rcf_tpu_torch/csrc/linear.cu``) in turns on one card.

    python3 tools/time_linear_variants.py [--variants a,b,...] [--sets qkv,fc1] [--rounds 2]

Builds every variant of ``VARIANTS`` (text replacements in a copy of
``linear.cu``, ``linear_kernels.LIB.build_patched``; ``release`` is the
source as it is), one nvcc each, side by side, and prints for each library
the registers and spills of each instance and the compiler's warnings and
notes (a ``C75xx`` one says that ptxas serialised the asynchronous
products). Then, for each of the DINO cell's four linears
(``kernel_sets.LINEAR_SETS``: qkv, proj with the residual, fc1 with GELU,
fc2 with the residual, M = 8 x 6,421), each variant's gap to a float64
linear (``kernel_sets.linear_gap``) and its device time
(``chip_smoke.graph_ms`` on ``cold_sets`` input sets), in turns (the
variants, then the same in reverse), ``--rounds`` times, beside the split-TF32
floor and cuBLAS's f32 GEMM (``F.linear``, the yardstick) and TF32 GEMM.
Last, one JSON line with the card's name and power limit.

The diagnostics compute another function on purpose (they fail the gap) and
show what the time is made of: ``diag_one_tf32`` forms one TF32 product for
each f32 one; ``diag_products_only`` runs the products on the slices already
in shared memory and nothing else (no copies, split, sums or epilogue);
``diag_no_epilogue`` computes but never stores the tiles; ``diag_no_split``
keeps the first slice's fragments; ``diag_no_sum`` drops the partial sums.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

# Each old text occurs exactly once in linear.cu.
_LOOP = "  for (int f = 0; f < total; ++f) {\n    const uint32_t wh = ring_addr"
_PRODUCTS_ONLY = ("  for (int f = 0; f < total; ++f) {\n"
                  "    const uint32_t wh = ring_addr + (f % kBuffers) * kBuffer + kXBytes, wl = wh + kPart;\n"
                  "    wgmma_fence();\n"
                  "#pragma unroll\n"
                  "    for (int ks = 0; ks < kSteps; ++ks)\n"
                  "      wgmma3(part, ah[ks], al[ks], operand(wh + ks * kCols * 32), "
                  "operand(wl + ks * kCols * 32), ks > 0);\n"
                  "    wgmma_commit();\n"
                  "    wgmma_wait_all();\n"
                  "  }\n"
                  "  pin(part);\n"
                  "  if (part[0] == 12345.f) out[threadIdx.x] = part[1];\n"
                  "  for (int f = 1; f < kBuffers - 1 && f < total; ++f) bar_wait(full + 8 * f, 0);\n"
                  "  return;\n")
VARIANTS = {
    "release": [],
    "diag_one_tf32": [("  wgmma(d, al, bh, add);\n  wgmma(d, ah, bl, 1);\n  wgmma(d, ah, bh, 1);\n",
                       "  wgmma(d, ah, bh, add);\n")],
    "diag_products_only": [(_LOOP, _PRODUCTS_ONLY + _LOOP)],
    "diag_no_epilogue": [("    if (finished >= 0) {  // the last tile's epilogue, under this slice's products\n"
                          "      epilogue(finished);",
                          "    if (finished >= 0) {  // the last tile's epilogue, under this slice's products\n"
                          "      if (acc[0] == 12345.f) epilogue(finished);")],
    "diag_no_split": [("    if (f + 1 < total) split_x();\n", "")],
    "diag_no_sum": [("      for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);",
                     "      for (int i = 0; i < kAcc; ++i) acc[i] = acc[i];")],
}


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    import kernel_sets as ks
    from rcf_tpu_torch.ops import cuda_build
    from rcf_tpu_torch.ops import linear_kernels as lk
    from rcf_tpu_torch.utils.precision import full_f32

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sets", default="qkv,proj,fc1,fc2")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    names = args.variants.split(",")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        sos = {v: pool.submit(lk.LIB.build_patched, VARIANTS[v], f"linear_{v}") for v in names}
        sos = {v: f.result() for v, f in sos.items()}
    libs = {}
    for v, so in sos.items():
        with open(so[:-3] + ".log") as f:
            notes = [ln.strip() for ln in f if "warning" in ln.lower() or "C75" in ln]
        for r in cuda_build.ptxas_entries(so):
            print(json.dumps({"variant": v, **r}), flush=True)
        print(json.dumps({"variant": v, "warnings": notes[:4]}), flush=True)
        libs[v] = lk.LIB.load(so)

    out = {}
    with torch.no_grad(), full_f32():
        for name in args.sets.split(","):
            m, k, n, _, _ = ks.LINEAR_SETS[name]
            sets = [ks.linear_inputs(name, "cuda")]
            sets += [{key: (val.roll(i + 1, 0) if torch.is_tensor(val) and val.dim() == 2
                            and val.shape[0] == m else val) for key, val in sets[0].items()}
                     for i in range(cs.cold_sets(cs.nbytes(sets[0]["x"])) - 1)]
            row = {"split_floor_ms": 3 * 2 * m * k * n / cs.TF32_FLOPS * 1e3,
                   "cublas_f32_ms": cs.graph_ms(torch, [
                       lambda a=a: F.linear(a["x"], a["weight"], a["bias"]) for a in sets],
                       iters=10, reps=3)}
            torch.backends.cuda.matmul.allow_tf32 = True
            row["cublas_tf32_ms"] = cs.graph_ms(torch, [
                lambda a=a: F.linear(a["x"], a["weight"], a["bias"]) for a in sets], iters=10, reps=3)
            torch.backends.cuda.matmul.allow_tf32 = False
            times = {v: [] for v in names}
            for v in names:
                with lk.LIB.using(libs[v]):
                    row[f"{v}_gap"] = ks.linear_gap(lk.dino_linear(**sets[0]), sets[0])
            for _ in range(args.rounds):
                for v in names + names[::-1]:
                    with lk.LIB.using(libs[v]):
                        times[v].append(cs.graph_ms(
                            torch, [lambda a=a: lk.dino_linear(**a) for a in sets], iters=10, reps=3))
            for v in names:
                ms = sorted(times[v])[len(times[v]) // 2]
                row[v] = {"device_ms": times[v], "median_ms": ms,
                          "split_floor_pct": 100 * row["split_floor_ms"] / ms}
            out[name] = row
            print(json.dumps({"set": name, **row}), flush=True)
            del sets
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
