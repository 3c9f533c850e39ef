"""The runner ``grouping_frames``: one card, the device stage of RCF's semantic
constraint as the tool runs it, ``rcf_tpu_torch.grouping.semantic_constraints.
semantic_refine`` on a batch of frames a step (the keys of the batch in one
ViT call, then each frame's affinity and NCut refinement).

Set-up (counted in ``setup_s``): the configuration's weights from the seed on
the device (``reference.make_weights``), the port's ViT
(``nn.dino_vit.DinoViT``) loaded with them inside
``grouping.pipeline.DinoFeatures(model=...)``, the feed, then the first three
steps, which the output check follows, and the warm-up steps. A program
without ``semantic_refine`` or ``DinoFeatures(model=...)`` fails at once.

Then the window (``harness/core.py``), with ``--trace 1`` the traced steps
(the program's spans read by ``harness/spans.py``, its counters
``grouping.STATS`` over the labelled pass), and, once the program's state is
freed, the plain reference over the three checked batches.

The numbers of the check (worst over the 24 checked frames); those the
workload gives a limit decide ``correct``, the others are printed:

* ``keys.worst_frame``: |keys - reference's| / |reference's| of the last
  block's keys, which a forward hook on its ``qkv`` catches in the timed
  call;
* ``affinity.flipped``: the share of a frame's affinity pairs that the
  program's ``build_affinity`` puts on the other side of tau from the
  reference's;
* ``ncut_before.worst_frame``, ``ncut_after.worst_frame``: the relative gap
  of the NCut value (the program's ``soft_ncut_value`` on its keys) of the
  mask at the grid and of the refined mask;
* ``mask.max_gap``: the largest |refined mask - reference's| over every cell;
  ``mask.mean_gap`` the mean; ``grid.max_gap`` the same of the masks at the
  grid; ``affinity.above_tau``: the reference's share of pairs above tau.

Controls (``python3 port_bench/runners/grouping_frames.py --seeds 1,2
--controls sound,tf32,drop_head,steps_9`` on the card): the reference with
TF32 on, with one head's attention output left out, or with 9 NCut steps in
the program's place; ``sound`` runs the whole cell at a one-second window.
"""

from __future__ import annotations

import gc
import os
import sys
import time

if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]

from harness import core, spans, spec  # noqa: E402

CHECKED_STEPS = 3
CONTROLS = ("tf32", "drop_head", "steps_9")


def _program():
    """The program's entry points, or a clear failure where it lacks them."""
    import inspect

    from rcf_tpu_torch.grouping import pipeline, semantic_constraints

    if not hasattr(semantic_constraints, "semantic_refine") or \
            "model" not in inspect.signature(pipeline.DinoFeatures).parameters:
        raise SystemExit("port_bench: this rcf_tpu_torch has no semantic_refine or "
                         "DinoFeatures(model=...): it cannot run the cell")
    import rcf_tpu_torch.grouping as grouping
    from rcf_tpu_torch.grouping import ncut
    from rcf_tpu_torch.nn.dino_vit import DinoViT

    return grouping, ncut, pipeline, semantic_constraints, DinoViT


def build(cfg: dict, weights: dict, dev):
    """The program's ``DinoFeatures`` around the port's ViT with ``weights``."""
    _, _, pipeline, _, DinoViT = _program()
    a = cfg["arch"]
    vit = DinoViT(patch_size=a["patch_size"], embed_dim=a["embed_dim"], depth=a["depth"],
                  num_heads=a["num_heads"], mlp_ratio=a["mlp_hidden_dim"] / a["embed_dim"],
                  train_grid=a["pos_grid"])
    vit.load_state_dict(weights, strict=True)
    return pipeline.DinoFeatures(model=vit.to(dev), resize_imgs_size=tuple(cfg["resize"]))


def program_readings(ncut, dino, keys: list, batches: list, refined: list, tau: float, eps: float) -> dict:
    """The program's side of the check from what its checked steps made: the keys,
    the masks at the grid and refined, and its NCut values of both."""
    import torch

    out = {"keys": [], "grid": [], "refined": [], "ncut_before": [], "ncut_after": []}
    for k, b, r in zip(keys, batches, refined):
        grid = dino.mask_to_grid(b["masks"])
        for key, value in (("keys", k), ("grid", grid), ("refined", r),
                           ("ncut_before", ncut.soft_ncut_value(k, grid, tau, eps)),
                           ("ncut_after", ncut.soft_ncut_value(k, r, tau, eps))):
            out[key].append(value.cpu())
    return {key: torch.cat(v) for key, v in out.items()}


def numbers(prog: dict, ref: dict, affinity_of, ref_affinity, dev) -> dict:
    """The check's numbers (module note), each a worst case over the frames."""
    import torch

    keys_gap, flipped = 0.0, 0.0
    for kp, kr in zip(prog["keys"], ref["keys"]):
        kp, kr = kp.to(dev), kr.to(dev)
        keys_gap = max(keys_gap, float((kp - kr).norm() / kr.norm()))
        flipped = max(flipped, float((affinity_of(kp) != ref_affinity(kr)).float().mean()))

    def rel(key):
        a, b = prog[key].double(), ref[key].double().cpu()
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())

    gap = (prog["refined"] - ref["refined"].cpu()).abs()
    return {"keys.worst_frame": keys_gap, "affinity.flipped": flipped,
            "ncut_before.worst_frame": rel("ncut_before"), "ncut_after.worst_frame": rel("ncut_after"),
            "mask.max_gap": float(gap.max()), "mask.mean_gap": float(gap.mean()),
            "grid.max_gap": float((prog["grid"] - ref["grid"].cpu()).abs().max())}


def reference_readings(ref, weights: dict, batches: list, cfg: dict, control: str | None = None) -> dict:
    """The reference over ``batches`` (``control``: one of ``CONTROLS``)."""
    import torch

    kw = {"tf32": {"tf32": True}, "drop_head": {"drop_head": 0}, "steps_9": {"steps": 9}}.get(control, {})
    parts = [ref.semantic_refine(weights, b["imgs01"], b["masks"], cfg, **kw) for b in batches]
    return {k: torch.cat([p[k].cpu() for p in parts]) for k in parts[0]}


def run(bench: dict, cell: dict, wl: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None, trace_dir: str | None = None) -> dict:
    """Run the cell; returns the result line (a dict) without printing it. The
    cell plants no fault: its controls stand in the program's place instead."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    grouping, ncut, _, sc, _ = _program()
    if int(cell.get("chips", 1)) != 1:
        raise ValueError("the grouping_frames runner drives one card")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    ref = spec.module("reference", cfg["reference"])
    tau, eps = float(cfg["ncut"]["tau"]), float(cfg["ncut"]["eps"])
    frames = int(wl["traffic"]["frames"])

    # ---- set-up ----
    weights = ref.make_weights(cfg["arch"], seed, dev)
    dino = build(cfg, weights, dev)
    feed = spec.module("feeds", wl["traffic"]["feed"]).make(wl, cfg, None, seed, dev)
    caught: list = []
    hook = dino.model.blocks[-1].attn.qkv.register_forward_hook(
        lambda module, args, out: caught.append(out.detach()[..., out.shape[-1] // 3: 2 * out.shape[-1] // 3]))
    checked, refined = [], []
    for _ in range(CHECKED_STEPS):
        batch = feed.next()
        checked.append(batch)
        refined.append(sc.semantic_refine(dino, batch["imgs01"], batch["masks"]))
    hook.remove()
    prog = program_readings(ncut, dino, caught, checked, refined, tau, eps)
    del caught, refined
    # What the check keeps waits on the host, so that the window's memory is the program's.
    weights = core.to(weights, "cpu")
    checked = [core.to(b, "cpu") for b in checked]

    def run_step(batch):
        return sc.semantic_refine(dino, batch["imgs01"], batch["masks"]).sum()

    for _ in range(int(wl["warmup_steps"])):
        run_step(feed.next())
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    core.log(f"set-up {setup_s:.3f} s")

    # ---- the window ----
    win = core.window(feed.next, run_step, seconds, cuda)
    core.log(f"window {win['seconds']:.3f} s, {win['steps']} steps, {win['steps'] * frames} frames")

    device_extra, breakdown = {}, None
    if not trace:
        metrics = core.end_to_end(bench, cell, {
            "frames_per_s": win["steps"] * frames / win["seconds"] if win["seconds"] > 0 else float("nan"),
            "step_ms_p90": core.percentile(win["gaps_ms"], 90) if win["gaps_ms"] else float("nan"),
            "peak_mem_gib": win["peak_bytes"] / 2**30,
            "setup_s": setup_s})
    else:
        trace_steps = int(wl["trace_steps"])
        with spans.captured() as got:
            red = core.traced(feed.next, run_step, trace_steps, cuda,
                              trace_dir or os.environ.get("TMPDIR") or ".", cell["name"],
                              after_device_pass=grouping.reset_stats)
        counted = dict(grouping.STATS)        # the labelled pass's
        n_tokens = ref.tokens(cfg)
        work = ref.attention_work(n_tokens, cfg["arch"])
        blocks = counted["attention_pairs"] / max(counted["frames"], 1) / (
            int(cfg["arch"]["num_heads"]) * n_tokens * n_tokens)
        ctx = {"trace_steps": trace_steps, "kernels": red["kernels"], "busy_s": red["busy_s"],
               "window_s": red["window_s"], "span_ms": spans.span_ms(got["trace"]),
               "span_frames": counted["frames"],
               "attention_work": {k: v * blocks * counted["frames"] for k, v in work.items()},
               "window_frames": win["steps"] * frames, "window_seconds": win["seconds"],
               "flops_per_frame": ref.frame_flops(n_tokens, cfg["arch"]),
               "compute_dtype": cfg["compute_dtype"], "chips": 1}
        metrics = core.per_layer(bench, cell, ctx)
        device_extra = {"busy_s": red["busy_s"], "window_s": red["window_s"], "counters": counted}
        breakdown = {"device_ops": red["top_ops"], "idle_gaps": red["idle_gaps"]}
        core.log(f"traced {trace_steps} steps: busy {red['busy_s']:.4f} s of {red['window_s']:.4f} s; "
                 f"counters {counted}")

    # ---- the output check, after the program's state is freed ----
    memory_peak = max(peak_setup, win["peak_bytes"])
    feed.close()
    del dino, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    weights = core.to(weights, dev)
    checked = [core.to(b, dev) for b in checked]
    reference = reference_readings(ref, weights, checked, cfg)
    nums = numbers(prog, reference, lambda k: ncut.build_affinity(k, tau, eps),
                   lambda k: ref.affinity(k, tau, eps), dev)
    share = [float((ref.affinity(k.to(dev), tau, eps) == 1).float().mean()) for k in reference["keys"]]
    nums["affinity.above_tau"] = sum(share) / len(share)
    core.log(f"reference {time.perf_counter() - t_ref:.3f} s")
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak), **device_extra}
    return core.result_line(nums, wl["limits"], win["steps"], win["failed"], metrics, dev_info, breakdown)


def control_numbers(wl: dict, cfg: dict, seed: int, control: str, device: str = "cuda") -> dict:
    """A control's reading of each number: the reference under ``control`` in the
    program's place, against the reference, on the cell's three checked batches."""
    import torch

    dev = torch.device(device)
    ref = spec.module("reference", cfg["reference"])
    tau, eps = float(cfg["ncut"]["tau"]), float(cfg["ncut"]["eps"])
    weights = ref.make_weights(cfg["arch"], seed, dev)
    feed = spec.module("feeds", wl["traffic"]["feed"]).make(wl, cfg, None, seed, dev)
    batches = [feed.next() for _ in range(CHECKED_STEPS)]
    feed.close()
    exact = reference_readings(ref, weights, batches, cfg)
    low = reference_readings(ref, weights, batches, cfg, control)
    return numbers(low, exact, lambda k: ref.affinity(k, tau, eps), lambda k: ref.affinity(k, tau, eps), dev)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="readings of the grouping cell's controls")
    ap.add_argument("--workload", default="dino_vits8_f32.ncut_frames")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="sound," + ",".join(CONTROLS))
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    wl, cfg = spec.workload(args.workload), spec.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in filter(None, args.controls.split(",")):
            if control == "sound":
                numbers_ = run(bench, cell, wl, cfg, seed, 1.0, False)["readings"]
            else:
                numbers_ = control_numbers(wl, cfg, seed, control)
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": control,
                              "numbers": numbers_}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
