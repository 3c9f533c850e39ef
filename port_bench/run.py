"""Run one cell of the benchmark of ``rcf_tpu_torch`` once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, its runner, feed
and reference, and its metrics are found by name (``BENCHMARK.json``,
``port_bench/workloads/``, ``port_bench/configs/``, ``port_bench/runners/``,
``port_bench/feeds/``, ``port_bench/reference/``, ``port_bench/metrics/``).
Exits non-zero with no result where no CUDA device (or fewer than the cell
asks for) is visible, and where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``rcf_tpu`` is loaded once the window has closed. The last line on
standard output is the result (JSON); the numbers of the output check, each
beside its limit, are the last lines on standard error and the result's
last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BANNED = ("jax", "jaxlib", "flax", "rcf_tpu")


def _caches() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    cache = os.path.join(BENCH_DIR, "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    _caches()
    from harness import spec

    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    wl = spec.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: the cell needs {cell['chips']} CUDA device(s), {count} visible",
              file=sys.stderr)
        return 3
    runner = spec.module("runners", wl["runner"])
    result = runner.run(bench, cell, wl, spec.config(cell["config"]), args.seed, args.seconds,
                        bool(args.trace), t_start=T_START)
    found = banned_modules()
    if found:
        print(f"port_bench: the JAX side is loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
