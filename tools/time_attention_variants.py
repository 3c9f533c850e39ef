#!/usr/bin/env python3
"""Time design variants of ``dino_attention`` (``rcf_tpu_torch/csrc/attention.cu``) in turns on one card.

    python3 tools/time_attention_variants.py [--variants a,b,...] [--rounds 2]

Builds every variant of ``VARIANTS`` (text replacements in a copy of
``attention.cu``, ``attention_kernels.LIB.build_patched``; ``release`` is
the source as it is), one nvcc each, side by side, and prints for each
library the registers and spills of each instance and the compiler's
warnings (a ``C75xx`` one says that ptxas serialised the asynchronous
products). Then, for each variant, the gap to a float64 attention
(``kernel_sets.attention_gap``) on the card tests' sets
(``kernel_sets.ATTENTION_SETS``: one frame of the DINO cell, 1 x 6,421
tokens, 6 heads of 64; head dim 32, 1 x 1,591 x 12 heads; q, k, v of spread
1 and 2; ragged N), and its device time at one block's call of the cell (8 x 6 x
6,421^2, ``chip_smoke.graph_ms`` on ``cold_sets``), in turns (the variants,
then the same in reverse), ``--rounds`` times, beside the TF32 floor. Last,
one JSON line with the card's name and power limit. ``wait_pv`` waits for
each tile's P V in the tile; ``pingpong`` has the two warpgroups issue their
Q K^T in turns (named barriers); the diagnostics compute another function on
purpose (they fail the gap): ``diag_one_tf32`` forms one TF32 product for
each f32 one (what the two others cost), ``diag_carry`` carries O in the
tensor cores' accumulator across the key tiles. Needs a CUDA device; imports
no JAX.
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

# Each old text occurs exactly once in attention.cu.
_SPLIT3 = ("  wgmma<N>(d, al, bh, add);\n  wgmma<N>(d, ah, bl, 1);\n  wgmma<N>(d, ah, bh, 1);\n",
           "  wgmma<N>(d, ah, bh, add);\n")
_CARRY = [
    ("      pin(pv);\n      wgmma_fence();",
     "#pragma unroll\n      for (int i = 0; i < HD / 2; ++i) pv[i] = __fmul_rn(pv[i], (i & 2) ? a1 : a0);\n"
     "      pin(pv);\n      wgmma_fence();"),
    ("operand(vl + kk * HD * 32), kk > 0);", "operand(vl + kk * HD * 32), 1);"),
    ("o[i] = __fmaf_rn(o[i], (i & 2) ? a1 : a0, pv[i]);", "o[i] = pv[i];"),
]
# P V waited for in its own tile, O updated there (the schedule before P V was
# left in flight across the barrier).
_WAIT_PV = [("      wgmma_commit();\n    }\n",
             "      wgmma_wait_all();\n      pin(pv);\n      update_o();\n      a0 = a1 = 1.f;\n"
             "#pragma unroll\n      for (int i = 0; i < HD / 2; ++i) pv[i] = 0.f;\n    }\n")]
# The two warpgroups issue their Q K^T in turns, warpgroup 0 first (named
# barriers 1 and 2), so that one's softmax runs against the other's products.
_QK = ("    if (active) {\n      pin(s);\n      wgmma_fence();\n#pragma unroll\n"
       "      for (int ks = 0; ks < kSteps; ++ks)\n"
       "        wgmma3<kKeys>(s, qh[ks], ql[ks], operand(kh + ks * kKeys * 32), "
       "operand(kl + ks * kKeys * 32),\n                      ks > 0);\n"
       "      wgmma_wait_all();  // ... and the previous tile's P V\n")
_PINGPONG = [
    ("__device__ __forceinline__ float ex2(float x) {",
     '__device__ __forceinline__ void named_sync(int id) {\n'
     '  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "n"(kThreads) : "memory");\n}\n\n'
     '__device__ __forceinline__ void named_arrive(int id) {\n'
     '  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "n"(kThreads) : "memory");\n}\n\n'
     "__device__ __forceinline__ float ex2(float x) {"),
    ("  for (int j = 0; j < nt; ++j) {\n",
     "  const int wg = warp >> 2;\n  if (wg == 1) named_arrive(1);\n  for (int j = 0; j < nt; ++j) {\n"),
    (_QK, _QK.replace("      wgmma_wait_all();  // ... and the previous tile's P V\n",
                      "      wgmma_commit();\n    }\n    named_arrive(2 - wg);\n    if (active) {\n"
                      '      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");\n')
          .replace("    if (active) {\n      pin(s);", "    named_sync(1 + wg);\n    if (active) {\n      pin(s);", 1)),
    ("  if (!active) return;\n", "  if (wg == 0) named_sync(1);  // warpgroup 1's last arrival\n  if (!active) return;\n"),
]
VARIANTS = {"release": [], "wait_pv": _WAIT_PV, "pingpong": _PINGPONG, "diag_one_tf32": [_SPLIT3],
            "diag_carry": _CARRY}


def main() -> int:
    import torch

    import chip_smoke as cs
    import kernel_sets as ks
    from rcf_tpu_torch.ops import attention_kernels as ak
    from rcf_tpu_torch.ops import cuda_build
    from rcf_tpu_torch.utils.precision import full_f32

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    names = args.variants.split(",")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        sos = {v: pool.submit(ak.LIB.build_patched, VARIANTS[v], f"attention_{v}") for v in names}
        sos = {v: f.result() for v, f in sos.items()}
    libs = {}
    for v, so in sos.items():
        with open(so[:-3] + ".log") as f:
            warnings = [ln.strip() for ln in f if "warning" in ln.lower()]
        for r in cuda_build.ptxas_entries(so):
            print(json.dumps({"variant": v, **r}), flush=True)
        print(json.dumps({"variant": v, "warnings": warnings[:4]}), flush=True)
        libs[v] = ak.LIB.load(so)

    b, n, heads, hd = cs.ATTN_CELL
    floor_ms = 4.0 * n * n * hd * b * heads / cs.TF32_FLOPS * 1e3
    with torch.no_grad(), full_f32():
        gap_inputs = {k: ks.attention_inputs(k) for k in ks.ATTENTION_SETS}
        gaps = {}
        for v in names:
            with ak.LIB.using(libs[v]):
                gaps[v] = {k: ks.attention_gap(ak.dino_attention(x), x)
                           for k, x in gap_inputs.items()}
        del gap_inputs
        sets = [ks.attention_qkv(b, n, heads, hd, seed=21 + i, device="cuda") for i in range(2)]
        sets += [ks.attention_qkv(b, n, heads, hd, seed=23 + i, device="cuda")
                 for i in range(cs.cold_sets(cs.nbytes(sets[0])) - 2)]
        times = {v: [] for v in names}
        for _ in range(args.rounds):
            for v in names + names[::-1]:
                with ak.LIB.using(libs[v]):
                    times[v].append(cs.graph_ms(
                        torch, [lambda x=x: ak.dino_attention(x) for x in sets], iters=10, reps=3))
    for v in names:
        ms = sorted(times[v])[len(times[v]) // 2]
        print(json.dumps({"variant": v, "gaps": gaps[v], "device_ms": times[v],
                          "median_ms": ms, "floor_pct": 100 * floor_ms / ms}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"shape": cs.ATTN_CELL, "floor_ms": floor_ms, "card": smi.stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
