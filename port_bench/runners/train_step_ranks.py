"""The runner ``train_step_ranks``: the port's training step over ranks, one card
and one process a rank, as the trainer runs it under a launcher. No cell
runs it yet: on four H100s its step was host-bound and its runs spread by
36-46% (``PERF.md`` §7 #1), so ``rcf_davis_f32.stage1_step_dp4`` was left out.

This process is rank 0; it starts ranks 1 to ``chips - 1`` as
``python3 port_bench/runners/train_step_ranks.py <job.json> <rank>``, each
joining the process group through the program's own
``parallel.dist.init_distributed`` (``RCF_COORDINATOR`` on a free
``tcp://localhost`` port, NCCL on the card, the rank's own card). Every rank
builds the stage's model from the weights of the seed and takes rank 0's
state (``dist.broadcast_state``, as the trainer does); its batches are its
rows of the workload's feed drawn for the global batch (rank ``r`` takes
global pair ``j * world + r`` as its pair ``j``, the loader's plan), so each
rank keeps its own pool on its own card; its dropout generator is seeded
with ``step_seed(seed, step)``, as the trainer seeds every rank, and the
heads draw their dropout for the whole batch and keep the rank's rows
(``nn/fcn_head.py``).

Rank 0 decides every step: before each it writes the step's kind to a
``TCPStore`` (``check``: a checked step, where a fault is planted; ``step``;
``done``), and the other ranks follow, so that all issue the same
collectives while rank 0 keeps the harness's window, its traced passes and
its events. A rank that dies ends the run at once, and so does rank 0's.

The check: rank 0's three checked steps (losses, the first gradient from
Adam's first moment, the changes of the parameters, its rows' mask logits)
against the plain reference over the three global batches
(``runners/train_step.py::reference_readings``), whose dropout draw over the
whole batch is every rank's. Faults: ``state_unchanged``,
``half_batch`` (every rank), ``exchange_left_out`` (no rank averages its
gradients).
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]

from harness import compare, core, spec  # noqa: E402

CHECKED_STEPS = 3
FAULTS = ("state_unchanged", "half_batch", "exchange_left_out")
# The plain reference's steps over the global batch: the one-card runner's.
reference_readings = spec.module("runners", "train_step").reference_readings
TIMEOUT_S = 300.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _rank_env(job: dict, rank: int):
    """The variables ``dist.init_distributed`` reads, for this rank, restored after."""
    env = {"RCF_COORDINATOR": f"localhost:{job['port']}", "RCF_NUM_PROCESSES": str(job["world"]),
           "RCF_PROCESS_ID": str(rank), "RCF_LOCAL_DEVICE_IDS": str(rank if job["device"] == "cuda" else 0)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _NoExchange:
    """``parallel.dist`` as the step sees it, with the gradients' mean left out."""

    def __init__(self, dist):
        self._dist = dist

    def all_reduce_mean_(self, tensors):
        return None

    def __getattr__(self, name):
        return getattr(self._dist, name)


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s pairs of a global batch: global pair ``j * world + rank``."""
    return {k: (v[rank::world].contiguous() if hasattr(v, "shape") and v.dim() > 0 else v)
            for k, v in batch.items()}


class _Rank:
    """One rank's model, state, step and local feed."""

    def __init__(self, job: dict, rank: int):
        import torch

        from rcf_tpu_torch.parallel import dist
        from rcf_tpu_torch.train import step as step_module
        from rcf_tpu_torch.train.state import create_train_state

        self.job, self.rank, self.world = job, rank, job["world"]
        self.torch, self.dist, self.step_module = torch, dist, step_module
        with _rank_env(job, rank):
            self.dev = dist.init_distributed(device=job["device"], backend=job.get("backend"),
                                             timeout_s=TIMEOUT_S)
        self.store = torch.distributed.TCPStore("localhost", job["cmd_port"], self.world, rank == 0,
                                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        cfg, stage, wl, seed = job["cfg"], job["stage"], job["wl"], job["seed"]
        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32_convolutions"])
        torch.backends.cuda.matmul.allow_tf32 = False
        train_step = spec.module("runners", "train_step")
        self.ref, self.params, self.buffers, self.model, self.step, _ = train_step.build(
            cfg, stage, seed, self.dev)
        feed = spec.module("feeds", wl["traffic"]["feed"]).make(wl, cfg, stage, seed, self.dev)
        self.global_batches = feed.batches if rank == 0 else None
        self.batches = [feed.to_device(local_rows(b, rank, self.world)) for b in feed.batches]
        self.state = create_train_state(dict(stage["train"], model_kwargs=stage["model_kwargs"]),
                                        self.model, feed.steps_per_epoch)
        dist.broadcast_state(self.state)
        feed.close()
        self.gen = torch.Generator(device=self.dev)
        self.steps = 0
        self.cmds = 0

    def batch(self) -> dict:
        return self.batches[self.steps % len(self.batches)]

    def run_step(self, kind: str, batch: dict | None = None):
        """One step of ``kind`` (``check`` plants the job's fault) on this rank's rows."""
        torch, fault = self.torch, self.job.get("fault")
        batch = self.batch() if batch is None else batch
        self.gen.manual_seed(self.ref.step_seed(self.job["seed"], self.steps))
        self.steps += 1
        if kind == "check" and fault == "state_unchanged":
            return {"loss": torch.tensor(float("nan"))}
        if kind == "check" and fault == "half_batch":
            half = batch["imgs"].shape[0] // 2
            batch = {k: (v[:half] if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}
        exchange = kind == "check" and fault == "exchange_left_out"
        if exchange:
            self.step_module.dist = _NoExchange(self.dist)
        try:
            return self.step(self.state, batch, generator=self.gen)
        finally:
            if exchange:
                self.step_module.dist = self.dist

    def announce(self, kind: str) -> None:
        """Rank 0: the next step's kind, for the other ranks."""
        self.store.set(f"cmd/{self.cmds}", kind)
        self.cmds += 1

    def follow(self) -> None:
        """Ranks 1 and up: run the steps rank 0 announces until ``done``."""
        while True:
            kind = self.store.get(f"cmd/{self.cmds}").decode()
            self.cmds += 1
            if kind == "done":
                break
            self.run_step(kind)
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()
        self.store.set(f"left/{self.rank}", "1")

    def close(self) -> None:
        self.dist.shutdown()


def _orphaned(parent: int) -> None:
    """End this rank at once where rank 0's process is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(6)


def _follower(job_path: str, rank: int) -> int:
    threading.Thread(target=_orphaned, args=(os.getppid(),), daemon=True).start()
    with open(job_path) as f:
        job = json.load(f)
    r = _Rank(job, rank)
    try:
        r.follow()
    finally:
        r.close()
    return 0


def _watch(procs: list, stop: threading.Event) -> None:
    """End the run at once where a rank exits with an error."""
    while not stop.wait(1.0):
        for p in procs:
            code = p.poll()
            if code not in (None, 0):
                core.log(f"port_bench: rank process {p.args[-1]} exited with {code}")
                os._exit(5)


def run(bench: dict, cell: dict, wl: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None, fault: str | None = None,
        trace_dir: str | None = None, world: int | None = None, backend: str | None = None) -> dict:
    """Run the cell from rank 0; returns the result line (a dict) without printing it."""
    t_start = time.perf_counter() if t_start is None else t_start
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    world = int(cell["chips"]) if world is None else world
    job = {"wl": wl, "cfg": cfg, "stage": spec.stage(wl["config"], wl["stage"]), "seed": seed,
           "fault": fault, "device": device, "backend": backend, "world": world,
           "port": _free_port(), "cmd_port": _free_port()}
    with tempfile.TemporaryDirectory() as tmp:
        job_path = os.path.join(tmp, "job.json")
        with open(job_path, "w") as f:
            json.dump(job, f)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job_path, str(r)])
                 for r in range(1, world)]
        stop = threading.Event()
        threading.Thread(target=_watch, args=(procs, stop), daemon=True).start()
        try:
            result = _lead(bench, cell, job, seconds, trace, t_start, trace_dir)
        finally:
            stop.set()
            for p in procs:
                try:
                    p.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank processes exited with {codes}")
    return result


def _lead(bench: dict, cell: dict, job: dict, seconds: float, trace: bool, t_start: float,
          trace_dir: str | None) -> dict:
    """Rank 0: the program's phase (``_program_phase``), then, with the program's
    state freed, the check against the reference."""
    import torch

    out = _program_phase(bench, cell, job, seconds, trace, t_start, trace_dir)
    gc.collect()
    dev = out["dev"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref, wl, stage, world = out["ref"], job["wl"], job["stage"], job["world"]
    reference = reference_readings(
        ref, stage["model_kwargs"], stage["train"], core.to(out["params"], dev), core.to(out["buffers"], dev),
        [core.to(b, dev) for b in out["checked"]], job["seed"], [])
    reference["logits"] = rank_rows(reference["logits"], 0, world)
    numbers = compare.training_numbers(out["prog"], reference)
    core.log(f"reference {time.perf_counter() - t_ref:.3f} s; losses {reference['losses']}")
    win = out["win"]
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                "count": world, "memory_peak_bytes": int(out["memory_peak"]), **out["device_extra"]}
    return core.result_line(numbers, wl["limits"], win["steps"], win["failed"], out["metrics"], dev_info,
                            out["breakdown"])


def _program_phase(bench: dict, cell: dict, job: dict, seconds: float, trace: bool, t_start: float,
                   trace_dir: str | None) -> dict:
    """Rank 0's set-up, checked steps, window and traced passes; what the check
    needs comes back on the host, and the program's state dies with this call."""
    r = _Rank(job, 0)
    torch, dist, world = r.torch, r.dist, r.world
    cuda = r.dev.type == "cuda"
    wl, cfg, stage = job["wl"], job["cfg"], job["stage"]
    pairs = int(wl["traffic"]["pairs"])
    try:
        trainable = {n: p for n, p in r.model.named_parameters() if n in r.params}
        by_id = {id(p): n for n, p in trainable.items()}
        logits: list = []
        hook = r.model.decode_head2.register_forward_hook(
            lambda module, args, out: logits.append(out.detach().float().cpu()))
        prog_losses, prog_grad = [], {}
        for k in range(CHECKED_STEPS):
            r.announce("check")
            losses = r.run_step("check")
            prog_losses.append(float(losses["loss"]))
            if k == 0:
                hook.remove()
                for group in r.state.optimizer.param_groups:
                    for p in group["params"]:
                        m = r.state.optimizer.state.get(p, {}).get("exp_avg")
                        prog_grad[by_id[id(p)]] = 0.0 if m is None else float(m.double().norm()) / 0.1
        out = {"ref": r.ref, "dev": r.dev,
               "prog": {"losses": prog_losses, "grad": prog_grad, "logits": logits[0] if logits else None,
                        "change": {n: float(torch.linalg.vector_norm((t.detach().float() - r.params[n]).double()))
                                   for n, t in trainable.items()},
                        "ema": {}},
               "params": core.to(r.params, "cpu"), "buffers": core.to(r.buffers, "cpu"),
               "checked": [core.to(b, "cpu") for b in r.global_batches[:CHECKED_STEPS]]}
        r.global_batches = None

        def next_batch():
            r.announce("step")
            return r.batch()

        def run_step(batch):
            return r.run_step("step", batch)["loss"]

        for _ in range(int(wl["warmup_steps"])):
            run_step(next_batch())
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
        core.log(f"rank 0 of {world}: set-up {setup_s:.3f} s; first losses {prog_losses}")

        win = core.window(next_batch, run_step, seconds, cuda)
        frames = win["steps"] * pairs * 2
        core.log(f"window {win['seconds']:.3f} s, {win['steps']} steps, {frames} frames (global batch)")
        out.update(win=win, memory_peak=max(peak_setup, win["peak_bytes"]), device_extra={}, breakdown=None)
        if not trace:
            out["metrics"] = core.end_to_end(bench, cell, {
                "frames_per_s": frames / win["seconds"] if win["seconds"] > 0 else float("nan"),
                "step_ms_p90": core.percentile(win["gaps_ms"], 90) if win["gaps_ms"] else float("nan"),
                "peak_mem_gib": win["peak_bytes"] / 2**30,
                "setup_s": setup_s})
        else:
            trace_steps = int(wl["trace_steps"])
            dist.reset_stats()
            counters: dict = {}
            red = core.traced(next_batch, run_step, trace_steps, cuda,
                              trace_dir or os.environ.get("TMPDIR") or ".", cell["name"],
                              after_device_pass=lambda: counters.update(dist.STATS))
            ctx = {"trace_steps": trace_steps, "kernels": red["kernels"], "busy_s": red["busy_s"],
                   "window_s": red["window_s"], "allreduce_calls": counters["all_reduce_calls"],
                   "window_steps": win["steps"], "window_seconds": win["seconds"],
                   "flops_per_step": r.ref.step_flops(stage["model_kwargs"], pairs, int(wl["traffic"]["hw"])),
                   "compute_dtype": cfg["compute_dtype"], "chips": world}
            out["metrics"] = core.per_layer(bench, cell, ctx)
            out["device_extra"] = {"busy_s": red["busy_s"], "window_s": red["window_s"], "counters": counters}
            out["breakdown"] = {"device_ops": red["top_ops"], "idle_gaps": red["idle_gaps"]}
            core.log(f"traced {trace_steps} steps: busy {red['busy_s']:.4f} s of {red['window_s']:.4f} s")
        r.announce("done")
        r.store.wait([f"left/{k}" for k in range(1, world)])
        if cuda:
            torch.cuda.synchronize()
    finally:
        r.close()
    return out


def rank_rows(frames, rank: int, world: int):
    """Rank ``rank``'s frame rows [2b, ...] of the global batch's [2B, ...] (pair-major)."""
    if frames is None:
        return None
    pairs = frames.shape[0] // 2
    return frames.reshape(pairs, 2, *frames.shape[1:])[rank::world].reshape(-1, *frames.shape[1:])


if __name__ == "__main__":
    sys.exit(_follower(sys.argv[1], int(sys.argv[2])))
