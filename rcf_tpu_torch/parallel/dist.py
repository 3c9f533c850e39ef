"""Data parallel over ranks (port of ``rcf_tpu/parallel/mesh.py`` and of the
multi-process initialization in ``rcf_tpu/cli.py``).

One process a card. Every rank holds the whole train state; the batch is
split by rank (``data/loader.py``); the gradients are averaged over ranks
before the optimizer, the BatchNorm statistics are reduced over ranks in
training (``nn/layers.py``), so every rank keeps the same state. That is
what JAX's global-view ``jit`` over a ``data`` mesh gives, written out.

``init_distributed`` reads the JAX package's variables:

* ``RCF_COORDINATOR`` (host:port), ``RCF_NUM_PROCESSES``,
  ``RCF_PROCESS_ID`` and ``RCF_LOCAL_DEVICE_IDS`` (the one card of this
  rank, default 0);
* or, with ``RCF_DIST=1``, a launcher's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun``).

The backend is NCCL on the card and gloo on the CPU unless the caller names
one (gloo on the card runs two ranks on one card, which NCCL refuses). A
failed initialization raises; nothing switches backend or device.

Every collective here is an ``all_reduce`` or a ``broadcast`` of tensors on
the rank's device, which NCCL and gloo both take. With a world of 1 (no
process group) none is issued and every path is the single-card one.

``STATS`` counts the collectives issued since ``reset_stats()``, by kind
(``all_reduce``; ``broadcast``; ``gather``, the all-reduce that
``gather_rows`` rebuilds a batch with): calls and payload bytes, so every
value stays 0 at a world of 1. Each public collective past its one-rank
return is a ``rcf.dist.<name>`` span (``train/metrics.py``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as tdist
from torch.profiler import record_function

# The device the collectives' own tensors live on (set by init_distributed).
_device = torch.device("cpu")

DEFAULT_TIMEOUT_S = 1800.0

# Collectives issued and their payload bytes, by kind, since the last reset_stats().
STATS = {f"{kind}_{what}": 0 for kind in ("all_reduce", "broadcast", "gather")
         for what in ("calls", "bytes")}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _count(kind: str, buf: torch.Tensor) -> None:
    STATS[f"{kind}_calls"] += 1
    STATS[f"{kind}_bytes"] += buf.numel() * buf.element_size()


def _all_reduce(buf: torch.Tensor, kind: str = "all_reduce", **kwargs) -> None:
    _count(kind, buf)
    tdist.all_reduce(buf, **kwargs)


def _broadcast(buf: torch.Tensor, src: int) -> None:
    _count("broadcast", buf)
    tdist.broadcast(buf, src)


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one writer of files every rank would otherwise write."""
    return rank() == 0


def requested() -> bool:
    """Whether the environment asks for a multi-process run."""
    return bool(os.environ.get("RCF_COORDINATOR") or os.environ.get("RCF_DIST"))


def joined() -> bool:
    """Whether this process has joined a process group."""
    return tdist.is_initialized()


def _ranks_from_env() -> tuple[int, int, int, str]:
    env = os.environ
    if env.get("RCF_COORDINATOR"):
        ids = [s for s in env.get("RCF_LOCAL_DEVICE_IDS", "0").split(",") if s.strip()]
        if len(ids) != 1:
            raise ValueError(f"RCF_LOCAL_DEVICE_IDS={env['RCF_LOCAL_DEVICE_IDS']!r}: the port runs "
                             "one card a process; give the one id")
        return (int(env["RCF_PROCESS_ID"]), int(env["RCF_NUM_PROCESSES"]), int(ids[0]),
                f"tcp://{env['RCF_COORDINATOR']}")
    if env.get("RCF_DIST"):
        return (int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0)),
                "env://")
    raise ValueError("init_distributed needs RCF_COORDINATOR/RCF_NUM_PROCESSES/RCF_PROCESS_ID "
                     "or RCF_DIST=1 with a launcher's RANK/WORLD_SIZE/LOCAL_RANK")


def init_distributed(device: str | torch.device = "cuda", backend: str | None = None,
                     init_method: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group the environment describes and return this rank's device.

    ``device="cuda"`` sets the rank's card (``LOCAL_RANK`` or the one id of
    ``RCF_LOCAL_DEVICE_IDS``); ``"cpu"`` runs the rank on the CPU.
    ``init_method`` overrides the rendezvous the variables give (a
    ``file://`` path in the tests).
    """
    global _device
    rk, size, local, method = _ranks_from_env()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' to run "
                               "the ranks on the CPU")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tdist.init_process_group(backend, init_method=init_method or method, rank=rk,
                             world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    _device = dev
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _device
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _device = torch.device("cpu")


def check_mesh_shape(mesh_shape, size: int | None = None) -> None:
    """Raise where ``tpu.mesh_shape`` does not describe ``size`` ranks.

    JAX's ``create_mesh`` takes one ``data`` axis: ``[-1]`` spans every
    device and ``[n]`` must be the device count (the reshape fails
    otherwise); more axes or any other value fail there too.
    """
    size = world() if size is None else size
    shape = [int(n) for n in (mesh_shape or [-1])]
    if len(shape) != 1 or (shape[0] != -1 and shape[0] != size):
        raise ValueError(f"tpu.mesh_shape {shape} does not match {size} rank(s): use [-1] or "
                         f"[{size}] (one data axis over the ranks)")


def _flat(tensors: list[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """One flat buffer on the collectives' device (an optimizer's step counts
    may live on the CPU while the model is on the card)."""
    return torch.cat([t.detach().reshape(-1).to(_device, dtype) for t in tensors])


def _unflat_(buf: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(buf[off:off + n].view(t.shape))
            off += n


def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks: one f32 all-reduce of a flat buffer."""
    tensors = [t for t in tensors if t is not None]
    if world() == 1 or not tensors:
        return
    with record_function("rcf.dist.all_reduce_mean"):
        buf = _flat(tensors, torch.float32)
        _all_reduce(buf)
        buf /= world()
        _unflat_(buf, tensors)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor; ``x`` itself with one rank)."""
    if world() == 1:
        return x
    with record_function("rcf.dist.all_reduce_sum"):
        out = x.detach().clone()
        _all_reduce(out)
    return out


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over ranks of ``x`` (no gradient through other ranks)."""
    if world() == 1:
        return x
    with record_function("rcf.dist.all_reduce_max"):
        out = x.detach().clone()
        _all_reduce(out, op=tdist.ReduceOp.MAX)
    return out


def mean_losses(losses: dict) -> dict:
    """Each (scalar) loss averaged over ranks, in its dtype: the whole batch's losses."""
    if world() == 1:
        return losses
    with record_function("rcf.dist.mean_losses"):
        keys = list(losses)
        vals = torch.stack([losses[k].detach().float().reshape(()) for k in keys])
        all_reduce_mean_([vals])
        return {k: v.reshape(losses[k].shape).to(losses[k].dtype) for k, v in zip(keys, vals)}


def global_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` of two batch means, as the whole batch's ratio.

    A ratio of means is not a mean over rows, so each rank's own ratio
    would not average to the global one. Here the value on every rank is
    ``N / D`` with ``N``, ``D`` the means over ranks (detached), and the
    rank's own ``num``, ``den`` carry the gradient, so that the ranks' mean
    gradient is that of ``N / D``.
    """
    if world() == 1:
        return num / den
    with record_function("rcf.dist.global_ratio"):
        g = torch.stack([num.detach().float(), den.detach().float()])
        all_reduce_mean_([g])
        n, d = g[0], g[1]
        out = n / d + (num - num.detach()) / d - n * (den - den.detach()) / (d * d)
        return out.to(torch.result_type(num, den))


def broadcast_(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s: one broadcast a dtype."""
    if world() == 1:
        return
    with record_function("rcf.dist.broadcast"):
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dtype, group in by_dtype.items():
            buf = _flat(group, dtype)
            _broadcast(buf, src)
            _unflat_(buf, group)


def _optimizer_tensors(optimizer) -> list[torch.Tensor]:
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            for key, v in sorted(optimizer.state.get(p, {}).items()):
                if isinstance(v, torch.Tensor):
                    out.append(v)
    return out


def broadcast_state(state, src: int = 0) -> None:
    """Rank ``src``'s train state on every rank (``replicate`` in JAX): the model's
    parameters and buffers, the optimizer's state and the step count."""
    if world() == 1:
        return
    with record_function("rcf.dist.broadcast_state"):
        model_tensors = list(state.model.state_dict().values())
        broadcast_(model_tensors + _optimizer_tensors(state.optimizer), src)
        step = torch.tensor([state.step], dtype=torch.int64, device=_device)
        _broadcast(step, src)
        state.step = int(step.item())


def gather_rows(local: torch.Tensor, rows: int) -> torch.Tensor:
    """The whole batch [rows, ...] from each rank's contiguous block of
    ``rows / world`` rows: each rank writes its block into a zero buffer,
    then one f32 all-reduce (adding zeros is exact)."""
    size = world()
    if size == 1:
        return local
    with record_function("rcf.dist.gather_rows"):
        per = rows // size
        buf = torch.zeros((rows, *local.shape[1:]), dtype=torch.float32, device=local.device)
        buf[rank() * per:(rank() + 1) * per] = local.float()
        _all_reduce(buf, kind="gather")
        return buf.to(local.dtype)


def local_rows(full: torch.Tensor, rows_per_sample: int = 1) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the whole batch.

    Rank ``r``'s local sample ``j`` is the global sample ``j * world + r``
    (the loader's plan); each sample spans ``rows_per_sample`` rows.
    """
    size = world()
    if size == 1:
        return full
    rest = full.shape[1:]
    return full.reshape(-1, size, rows_per_sample, *rest)[:, rank()].reshape(-1, *rest)


def barrier() -> None:
    """Wait for every rank (an all-reduce of one element on the rank's device)."""
    if world() == 1:
        return
    with record_function("rcf.dist.barrier"):
        _all_reduce(torch.zeros(1, device=_device))
