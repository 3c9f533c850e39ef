"""One rank of the port's data-parallel checks on the CPU (gloo).

    python tests/torch_dist_worker.py <work_dir> <rank> <world>

Imports torch and ``rcf_tpu_torch`` only. Joins the group through
``init_distributed`` (``RCF_DIST=1`` with ``RANK``/``WORLD_SIZE`` and a
``file://`` rendezvous in ``<work_dir>``), reads ``<work_dir>/inputs.pt``
(written by ``tests/test_torch_parallel.py``), runs every case in one
order on every rank and writes ``<work_dir>/out_<rank>.pt``. The
functions that run a case at one rank are the ones the test runs at world
1 in its own process, so both sides run the same code.
"""

from __future__ import annotations

import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rcf_tpu_torch.config import Config  # noqa: E402
from rcf_tpu_torch.eval.harness import Exporter  # noqa: E402
from rcf_tpu_torch.losses.unflow import UnFlowLossCfg, unflow_loss  # noqa: E402
from rcf_tpu_torch.models import build_model  # noqa: E402
from rcf_tpu_torch.models.amd import build_amd_model  # noqa: E402
from rcf_tpu_torch.nn.layers import BatchNorm2d  # noqa: E402
from rcf_tpu_torch.parallel import dist  # noqa: E402
from rcf_tpu_torch.train import checkpoint, loop  # noqa: E402
from rcf_tpu_torch.train import create_train_state, make_train_step, maybe_crf_fn  # noqa: E402
from rcf_tpu_torch.train.step import step_seed  # noqa: E402


def local_rows(batch: dict) -> dict:
    """This rank's rows of a global batch: global sample j * world + rank."""
    w, r = dist.world(), dist.rank()
    return {k: v[r::w] if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def bn_case(x: torch.Tensor, g: torch.Tensor) -> dict:
    """A training BatchNorm on this rank's contiguous block of x [N, C, H, W]
    with loss sum(y * g): output, running statistics, input and weight gradients."""
    per = x.shape[0] // dist.world()
    rows = slice(dist.rank() * per, (dist.rank() + 1) * per)
    bn = BatchNorm2d(x.shape[1])
    xr = x[rows].clone().requires_grad_(True)
    y = bn(xr)
    (y * g[rows]).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


def step_case(spec: dict) -> dict:
    """One train step of ``spec``'s model on this rank's rows: the losses, the
    averaged gradients (read as the optimizer starts) and the state after."""
    build = build_amd_model if spec["amd"] else build_model
    model = build(spec["model_kwargs"], device="cpu")
    model.load_state_dict(spec["state_dict"])
    state = create_train_state(spec["cfg"], model, steps_per_epoch=1)
    grads: dict = {}
    adam_step = state.optimizer.step

    def read_grads(*args, **kwargs):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return adam_step(*args, **kwargs)

    state.optimizer.step = read_grads
    step = make_train_step(crf_fn=maybe_crf_fn(model))
    batch = dict(local_rows(spec["batch"]), **spec.get("extra", {}))
    gen = torch.Generator().manual_seed(step_seed(0, 0))
    losses = step(state, batch, generator=gen)
    return {"losses": losses, "grads": grads,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def unflow_case(flows: list, im1: torch.Tensor, im2: torch.Tensor) -> dict:
    """The unFlow loss (backward-density occlusion) on this rank's rows and its
    gradient in the rank's finest flow."""
    w, r = dist.world(), dist.rank()
    mine = [f[r::w].clone().requires_grad_(True) for f in flows]
    loss = unflow_loss(mine, im1[r::w], im2[r::w], UnFlowLossCfg())[0]
    loss.backward()
    return {"loss": loss.detach(), "dflow0": mine[0].grad}


def ratio_case(a: torch.Tensor, b: torch.Tensor) -> dict:
    """``dist.global_ratio`` of mean(a^2) over mean(sigmoid(b)), both with a
    gradient, on this rank's rows: the value and its gradients in a and b."""
    w, r = dist.world(), dist.rank()
    mine_a, mine_b = (t[r::w].clone().requires_grad_(True) for t in (a, b))
    out = dist.global_ratio((mine_a * mine_a).mean(), torch.sigmoid(mine_b).mean())
    out.backward()
    return {"value": out.detach(), "da": mine_a.grad, "db": mine_b.grad}


def eval_case(spec: dict, out_dir: str) -> dict:
    """``loop.evaluate`` over ``spec``'s batches with an exporter and
    visualizations in this rank's own directories."""
    model = build_model(spec["model_kwargs"], device="cpu")
    model.load_state_dict(spec["state_dict"])
    state = create_train_state(spec["cfg"], model, steps_per_epoch=1)
    tag = f"r{dist.rank()}"
    exporter = Exporter(os.path.join(out_dir, f"eval_{tag}"), os.path.join(out_dir, f"exp_{tag}"),
                        export_all_seg=True, process_index=dist.rank(),
                        process_count=dist.world())
    vis_dir = os.path.join(out_dir, f"vis_{tag}")
    result = loop.evaluate(state, spec["batches"], 0.35, None, exporter=exporter,
                           save_vis_dir=vis_dir, device="cpu")
    return {"miou": result.miou, "miou_frame_avg": result.miou_frame_avg,
            "elected": result.elected_channel, "written": sorted(exporter.written),
            "vis": sorted(os.listdir(vis_dir)) if os.path.isdir(vis_dir) else []}


def checkpoint_case(spec: dict, out_dir: str) -> dict:
    """Restore the world-1 ``last`` of ``spec``, take one step, then save
    ``last`` and two top-k checkpoints into a directory every rank shares:
    which ranks wrote, the kept lists, and the state that was saved."""
    model = build_model(spec["model_kwargs"], device="cpu")
    state = create_train_state(spec["cfg"], model, steps_per_epoch=1)
    checkpoint.restore_checkpoint(spec["world1_last"], state)
    restored = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(step_seed(0, state.step))
    make_train_step()(state, local_rows(spec["batch"]), generator=gen)
    writes = []
    save = checkpoint._save

    def counted(*args):
        writes.append(args[1])
        return save(*args)

    checkpoint._save = counted
    ckpt_dir = os.path.join(out_dir, "ckpt_w2")
    if dist.is_main():
        os.makedirs(ckpt_dir, exist_ok=True)
    dist.barrier()
    keeper = checkpoint.TopKKeeper(ckpt_dir, k=2)
    for tag, metric in (("e0", 0.5), ("e1", 0.25), ("e2", 0.75)):
        keeper.save(state, metric, tag)
    checkpoint._save = save
    return {"restored": restored, "writes": writes, "kept": keeper.kept, "step": state.step,
            "saved": {k: v.clone() for k, v in model.state_dict().items()}}


def run_case(tree: dict) -> dict:
    """``loop.run`` of a config tree (train, validate, elect, checkpoint, test, export)."""
    result = loop.run(Config(tree), device="cpu")
    return {"miou": result.miou, "elected": result.elected_channel}


def main(work_dir: str) -> None:
    dist.init_distributed(device="cpu", init_method=f"file://{work_dir}/rendezvous",
                          timeout_s=120.0)
    try:
        inp = torch.load(os.path.join(work_dir, "inputs.pt"), weights_only=False)
        cases = [("bn", bn_case, (inp["bn_x"], inp["bn_g"]))]
        cases += [(name, step_case, (spec,)) for name, spec in inp["steps"].items()]
        cases += [("unflow", unflow_case, inp["unflow"]), ("ratio", ratio_case, inp["ratio"]),
                  ("eval", eval_case, (inp["eval"], work_dir)),
                  ("checkpoint", checkpoint_case, (inp["checkpoint"], work_dir)),
                  ("run", run_case, (inp["run"],))]
        out = {"rank": dist.rank(), "world": dist.world()}
        for name, fn, args in cases:
            t0 = time.perf_counter()
            out[name] = fn(*args)
            print(f"rank {dist.rank()}: {name} {time.perf_counter() - t0:.1f} s", flush=True)
        torch.save(out, os.path.join(work_dir, f"out_{dist.rank()}.pt"))
    finally:
        dist.shutdown()


if __name__ == "__main__":
    os.environ.update(RCF_DIST="1", RANK=sys.argv[2], WORLD_SIZE=sys.argv[3], LOCAL_RANK="0")
    torch.set_num_threads(2)
    main(sys.argv[1])
