"""The runner ``train_step``: one card, the port's training step as the trainer
drives it, fed by the workload's feed.

Set-up (counted in ``setup_s``): the weights from the seed on the device,
the stage's model (``rcf_tpu_torch.models.build_from_config``) loaded with
them, its train state and step (``train.state.create_train_state``,
``train.step.make_train_step`` with ``maybe_crf_fn``), the feed
(``port_bench/feeds/<traffic.feed>.py``), then the first three steps, which
the output check follows, and the cell's further warm-up steps: every shape
and kernel the window uses.

Then the window (``harness/core.py``), with ``--trace 1`` the traced steps,
and, once the program's state is freed, the configuration's plain reference
(``port_bench/reference/<reference>.py``) follows the three checked steps.

A feed (``make(wl, cfg, stage, seed, dev)``) gives ``steps_per_epoch``,
``next_host()``, ``to_device(batch)`` and ``close()``.
"""

from __future__ import annotations

import gc
import os
import time

from harness import compare, core, spec, weights

CHECKED_STEPS = 3
CRF_FAULTS = ("crf_target_altered", "crf_iters_fifth", "crf_colour_dropped")
FAULTS = ("state_unchanged", "half_batch") + CRF_FAULTS


def _norms(torch, now: dict, start: dict) -> dict:
    return {n: float(torch.linalg.vector_norm((t.detach().float() - start[n]).double())) for n, t in now.items()}


def _half(torch, batch: dict) -> dict:
    """Half of the batch left out: the step takes the mean over the rest."""
    half = batch["imgs"].shape[0] // 2
    return {k: (v[:half] if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}


def crf_fn_of(model, fault: str | None):
    """The step's CRF (None without a CRF loss); a CRF fault planted where the CRF
    makes its answer: every map inverted, a fifth of the iterations, or the
    colour features dropped (``srgb`` so wide that only position counts)."""
    from rcf_tpu_torch.train.step import maybe_crf_fn

    crf_fn = maybe_crf_fn(model)
    if crf_fn is None or fault not in CRF_FAULTS:
        return crf_fn
    if fault == "crf_target_altered":
        return lambda imgs, masks: 1.0 - crf_fn(imgs, masks)
    from rcf_tpu_torch.ops.crf import make_crf_fn

    change = ({"refine_iters": max(1, crf_fn.params.refine_iters // 5)} if fault == "crf_iters_fifth"
              else {"srgb": 1e9})
    return make_crf_fn(**dict(model.crf_head_kwargs or {}, **change))


def _catching(crf_fn, caught: list):
    """``crf_fn`` that keeps its first call's frames, masks and answer on the host."""
    if crf_fn is None:
        return None

    def caught_fn(imgs, masks):
        out = crf_fn(imgs, masks)
        if not caught:
            caught.append(tuple(t.detach().float().cpu() for t in (imgs, masks, out)))
        return out
    return caught_fn


def build(cfg: dict, stage: dict, seed: int, dev, fault: str | None = None):
    """The reference module, the weights from ``seed`` and the program's model,
    step and CRF catch (its first call's frames, masks and answer), as the
    cell's set-up makes them."""
    import torch

    from rcf_tpu_torch.models import build_from_config
    from rcf_tpu_torch.train.step import make_train_step

    ref = spec.module("reference", cfg["reference"])
    kw = stage["model_kwargs"]
    dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
    params, buffers = weights.make(*ref.specs(kw), seed, dev)
    model = build_from_config({"model_cls": stage["model_cls"], "model_kwargs": kw}, device=dev,
                              seed=0, dtype=dtype)
    model.load_state_dict({**params, **buffers}, strict=True)
    caught: list = []
    step = make_train_step(crf_fn=_catching(crf_fn_of(model, fault), caught))
    return ref, params, buffers, model, step, caught


def run(bench: dict, cell: dict, wl: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None, fault: str | None = None,
        trace_dir: str | None = None) -> dict:
    """Run the cell; returns the result line (a dict) without printing it."""
    import torch

    from rcf_tpu_torch.ops import crf as crf_ops
    from rcf_tpu_torch.train.state import create_train_state

    t_start = time.perf_counter() if t_start is None else t_start
    if int(cell.get("chips", 1)) != 1:
        raise ValueError("the train_step runner drives one card")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    stage = spec.stage(wl["config"], wl["stage"])
    kw, train = stage["model_kwargs"], stage["train"]
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32_convolutions"])
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = wl["traffic"]
    pairs = int(tr["pairs"])
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")

    # ---- set-up ----
    ref, params, buffers, model, step, caught = build(cfg, stage, seed, dev, fault)
    feed = spec.module("feeds", tr["feed"]).make(wl, cfg, stage, seed, dev)
    state = create_train_state(dict(train, model_kwargs=kw), model, feed.steps_per_epoch)
    gen = torch.Generator(device=dev)
    named = dict(model.named_parameters())
    trainable = {n: p for n, p in named.items() if n in params}
    ema_params = {n: p for n, p in named.items() if "_ema." in n}
    by_id = {id(p): n for n, p in trainable.items()}

    checked, prog_losses, prog_grad = [], [], {}
    # The mask head's logits of the first step as the timed path makes them, and in
    # stage 2.1 the EMA copies' logits that the CRF target starts from.
    heads = {"logits": [], "ema_logits": []}
    hooks = [getattr(model, head).register_forward_hook(
        lambda module, args, out, key=key: heads[key].append(out.detach().float().cpu()))
        for head, key in (("decode_head2", "logits"), ("decode_head2_ema", "ema_logits"))
        if hasattr(model, head)]
    for k in range(CHECKED_STEPS):
        batch = feed.to_device(feed.next_host())
        checked.append(batch)
        gen.manual_seed(ref.step_seed(seed, k))
        if fault == "state_unchanged":
            losses = {"loss": torch.tensor(float("nan"))}
        else:
            losses = step(state, _half(torch, batch) if fault == "half_batch" else batch, generator=gen)
        prog_losses.append(float(losses["loss"]))
        if k == 0:
            for hook in hooks:
                hook.remove()
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    m = state.optimizer.state.get(p, {}).get("exp_avg")
                    prog_grad[by_id[id(p)]] = 0.0 if m is None else float(m.double().norm()) / 0.1
    prog = {"losses": prog_losses, "grad": prog_grad,
            **{key: (got[0] if got else None) for key, got in heads.items()},
            "crf": caught[0] if caught else None,
            "change": _norms(torch, trainable, params),
            "ema": _norms(torch, ema_params, buffers)}
    # What the check keeps waits on the host, so that the window's memory is the program's.
    params, buffers = core.to(params, "cpu"), core.to(buffers, "cpu")
    checked = [core.to(b, "cpu") for b in checked]
    gstep = CHECKED_STEPS

    def next_batch():
        return feed.to_device(feed.next_host())

    def run_step(batch):
        nonlocal gstep
        gen.manual_seed(ref.step_seed(seed, gstep))
        gstep += 1
        return step(state, batch, generator=gen)["loss"]

    for _ in range(int(wl["warmup_steps"])):
        run_step(next_batch())
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    core.log(f"set-up {setup_s:.3f} s; first losses {prog_losses}")

    # ---- the window ----
    win = core.window(next_batch, run_step, seconds, cuda)
    frames = win["steps"] * pairs * 2
    core.log(f"window {win['seconds']:.3f} s, {win['steps']} steps, {frames} frames")

    device_extra, breakdown = {}, None
    if not trace:
        metrics = core.end_to_end(bench, cell, {
            "frames_per_s": frames / win["seconds"] if win["seconds"] > 0 else float("nan"),
            "step_ms_p90": core.percentile(win["gaps_ms"], 90) if win["gaps_ms"] else float("nan"),
            "peak_mem_gib": win["peak_bytes"] / 2**30,
            "setup_s": setup_s})
    else:
        trace_steps = int(wl["trace_steps"])
        crf_ops.reset_stats()
        counters = {}
        red = core.traced(next_batch, run_step, trace_steps, cuda,
                          trace_dir or os.environ.get("TMPDIR") or ".", cell["name"],
                          after_device_pass=lambda: counters.update(crf_ops.STATS))
        crf_iters = int(counters["iterations"])
        ctx = {"trace_steps": trace_steps, "kernels": red["kernels"], "busy_s": red["busy_s"],
               "window_s": red["window_s"],
               "crf_iters": crf_iters, "crf_images": 2 * pairs,
               "crf_grid": tuple((kw.get("crf_head") or {}).get("resolution") or (tr["hw"], tr["hw"])),
               "window_steps": win["steps"], "window_seconds": win["seconds"],
               "flops_per_step": ref.step_flops(kw, pairs, int(tr["hw"])),
               "compute_dtype": cfg["compute_dtype"], "chips": 1}
        metrics = core.per_layer(bench, cell, ctx)
        device_extra = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
        breakdown = {"device_ops": red["top_ops"], "idle_gaps": red["idle_gaps"]}
        core.log(f"traced {trace_steps} steps: busy {red['busy_s']:.4f} s of {red['window_s']:.4f} s")

    # ---- the output check, after the program's state is freed ----
    memory_peak = max(peak_setup, win["peak_bytes"])
    feed.close()
    del state, step, model, named, trainable, ema_params, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    params, buffers = core.to(params, dev), core.to(buffers, dev)
    checked = [core.to(b, dev) for b in checked]
    reference = reference_readings(ref, kw, train, params, buffers, checked, seed, list(prog["ema"]))
    if float(kw.get("w_crf", 0)) > 0:   # a step that made no CRF answer reads inf
        reference["crf"] = (crf_answer(ref, prog["crf"], kw.get("crf_head") or {}, dev)
                            if prog["crf"] is not None else torch.empty(0))
    numbers = compare.training_numbers(prog, reference)
    core.log(f"reference {time.perf_counter() - t_ref:.3f} s; losses {reference['losses']}")
    for key in ("grad", "change"):
        core.log(f"worst leaves of {key}: " + ", ".join(f"{n} {v:.3g}" for v, n in compare.worst_leaves(
            prog[key], reference[key], compare.kept_leaves(reference["grad"]))))
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak), **device_extra}
    return core.result_line(numbers, wl["limits"], win["steps"], win["failed"], metrics, dev_info, breakdown)


def crf_answer(ref, caught: tuple, head: dict, dev):
    """The reference's CRF answer [N, H, W] on the frames and object masks that the
    program's first step handed its CRF (those masks are the program's, made from
    the EMA copies that ``ema_logits.step1`` checks)."""
    import torch

    imgs, masks, _ = caught
    with torch.no_grad():
        return ref.crf_refine(imgs.to(dev), masks.to(dev), head).cpu()


def reference_readings(ref, kw: dict, train: dict, params: dict, buffers: dict, batches: list, seed: int,
                       ema_names: list, precision: str | None = None) -> dict:
    """The plain reference's losses, first gradient and changes over ``batches``
    from the benchmark's weights (``precision``: the control's)."""
    import torch

    trainer = ref.ReferenceTrainer(kw, train, params, buffers, precision=precision)
    losses, grad, logits, ema_logits = [], {}, None, None
    for k, batch in enumerate(batches):
        out = trainer.step(batch, seed, k)
        losses.append(out["losses"]["loss"])
        if k == 0:
            logits = out["logits"].float().cpu()
            ema_logits = None if out["ema_logits"] is None else out["ema_logits"].float().cpu()
            grad = {n: float(g.double().norm()) for n, g in out["grads"].items()}
    return {"losses": losses, "grad": grad, "logits": logits, "ema_logits": ema_logits,
            "change": _norms(torch, {n: trainer.p[n] for n in params}, params),
            "ema": _norms(torch, {n: trainer.buf[n] for n in ema_names}, buffers)}
