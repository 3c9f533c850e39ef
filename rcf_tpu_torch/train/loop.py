"""End-to-end train/eval harness (port of ``rcf_tpu/train/loop.py``).

The reference's Lightning ``Model`` + ``Trainer`` stack (`main.py`), in the
order of events of the JAX package's ``run``: config-driven datasets and
loaders, the train step (``train/step.py``) on one card, validation every
``check_val_every_n_epoch`` epochs with the object channel elected once
after ``set_object_channel_after_epoch``, the top-2 + ``last``
checkpoints on ``val_miou_frame_avg``, the final hard-argmax test
(``eval_pos_th = -1``) and the mask export.

Keys of the config's ``tpu`` block: ``compute_dtype`` (float32 or
bfloat16) and ``device_normalize`` (uint8 batches, normalized by the
model on the card) act; ``fused_optimizer`` selects torch's fused Adam
(``train/state.py``); ``mesh_shape`` must be ``[-1]`` or the number of
ranks (``check_tpu_keys``); ``scan_steps`` (K steps a dispatch, the same
math as K single steps) and ``donate_state`` have no effect in eager
PyTorch and are logged; ``profile_dir``/``profile_start``/``profile_steps``
trace steps of rank 0 with ``torch.profiler``.

Several ranks (``parallel/dist.py``; ``cli.py`` joins the group): each rank
loads ``global_batch_size / world`` rows a step (its shard of the JAX
loader's plan), the state is rank 0's after init or restore, evaluation
runs each rank's slice of every batch and rebuilds the batch's
probabilities on every rank (the same mIoU and election everywhere), the
export is sharded by sequence, and rank 0 alone writes the resolved
config, the elected channel, ``metrics.jsonl``, the visualizations and
the checkpoints. Each rank beats its own heartbeat file.

Every train step is written to ``metrics.jsonl`` at ``loss_log_interval``
with its host times: ``loader_wait_s`` (blocked on the next batch) and
``step_s`` (from the batch to the step's losses on the host); each epoch
with ``train_epoch_s`` and ``train_frames``; each evaluation with
``eval_frames`` and ``eval_s``.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import time

import numpy as np
import torch

from .. import yaml_subset
from ..data import DataLoader, VideoDataset, get_transform
from ..eval.harness import Evaluator, Exporter, frame_id_from_path
from ..models import build_from_config
from ..parallel import dist
from ..utils import get_logger, resolve_device
from ..utils.watchdog import CKPT_GRACE_S, COMPILE_GRACE_S, DEFAULT_GRACE_S, Heartbeat
from .checkpoint import (TopKKeeper, find_resumable, load_flownet, load_pretrained,
                         restore_checkpoint, save_checkpoint)
from .metrics import MetricsLogger, StepProfiler
from .state import compute_dtype, create_train_state
from .step import make_eval_step, make_train_step, maybe_crf_fn, step_seed

logger = get_logger()

_RCF_STEP_KEYS = ("imgs", "gt_fw_flows", "gt_bw_flows", "pl_masks")


def check_tpu_keys(cfg) -> None:
    """Raise where the ``tpu`` settings or the environment do not fit the ranks:
    a ``mesh_shape`` other than ``[-1]`` or the world size, or the
    multi-process variables set with no process group joined. Log the keys
    that have no effect in eager PyTorch."""
    tpu = cfg.get("tpu") or {}
    if "donate_state" in tpu:
        logger.info("tpu.donate_state has no meaning in eager PyTorch; ignored")
    if int(tpu.get("scan_steps", 1)) > 1:
        logger.info("tpu.scan_steps has no effect in eager PyTorch (one step a call, the "
                    "same math); ignored")
    if dist.requested() and not dist.joined():
        raise RuntimeError("RCF_COORDINATOR / RCF_DIST is set but no process group was joined: "
                           "run through rcf_tpu_torch.cli or call parallel.init_distributed first")
    dist.check_mesh_shape(tpu.get("mesh_shape", [-1]))


def _save_object_channel(ckpt_dir: str, channel: int, epoch: int) -> None:
    """Persist the elected object channel so that a resumed run restores it."""
    path = os.path.join(ckpt_dir, "object_channel.json")
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump({"object_channel": int(channel), "elected_at_epoch": int(epoch)}, f)
        os.replace(tmp, path)
    except OSError as exc:
        logger.warning(f"could not persist object channel: {exc}")


def _load_object_channel(ckpt_dir: str) -> int | None:
    try:
        with open(os.path.join(ckpt_dir, "object_channel.json")) as f:
            return int(json.load(f)["object_channel"])
    except (OSError, ValueError, KeyError):
        return None


def _device_normalize(cfg) -> bool:
    return bool((cfg.get("tpu") or {}).get("device_normalize", False))


def _transform(cfg, training: bool):
    tf = get_transform(cfg, training=training)
    if _device_normalize(cfg):
        tf.keep_uint8 = True
    return tf


def rank_batch_size(cfg) -> int:
    """This rank's rows a step: ``global_batch_size / world``.

    JAX's multi-process loader gives every process ``global_batch_size``
    rows, so a step there sees world x the recipe's batch; the port keeps
    the recipe's global batch, as JAX's one-process run over many devices
    does.
    """
    global_batch = int(cfg.get("global_batch_size", cfg.batch_size))
    if global_batch % dist.world():
        raise ValueError(f"global_batch_size {global_batch} does not divide by "
                         f"{dist.world()} ranks")
    return global_batch // dist.world()


def _build_loaders(cfg, training: bool, pin_memory: bool = False):
    dataset_registry = {"VideoDataset": VideoDataset}
    dataset_cls = dataset_registry[cfg.get("dataset_cls", "VideoDataset")]
    workers = int(cfg.get("workers", 8))
    if training:
        ds = dataset_cls(cfg.data_path, training=True, **cfg.dataset_kwargs.to_dict(),
                         **cfg.train_dataset_kwargs.to_dict())
        # force_no_shuffle: deterministic order for visualization (main.py:324-328).
        shuffle = not bool(cfg.get("force_no_shuffle", False))
        return DataLoader(ds, _transform(cfg, training=True),
                          batch_size=rank_batch_size(cfg), shuffle=shuffle,
                          seed=int(cfg.get("seed", 0)), num_workers=workers,
                          shard_index=dist.rank(), num_shards=dist.world(),
                          pin_memory=pin_memory)
    data_path = cfg.get("test_data_path") or cfg.data_path
    kwargs = cfg.test_dataset_kwargs.to_dict()
    sub = kwargs.pop("subsample_frame_interval", None)
    ds = VideoDataset(data_path, training=False, **cfg.dataset_kwargs.to_dict(),
                      subsample_frame_interval=sub, **kwargs)
    return DataLoader(ds, _transform(cfg, training=False), batch_size=int(cfg.batch_size),
                      shuffle=False, drop_last=False, num_workers=workers,
                      group_by_shape=True, pin_memory=pin_memory)


def _val_loader(cfg, subsample: int = 10, pin_memory: bool = False):
    """Validation = the test split, every 10th frame (main.py:339-346)."""
    data_path = cfg.get("test_data_path") or cfg.data_path
    kwargs = cfg.test_dataset_kwargs.to_dict()
    kwargs.pop("subsample_frame_interval", None)
    ds = VideoDataset(data_path, training=False, **cfg.dataset_kwargs.to_dict(),
                      subsample_frame_interval=subsample, **kwargs)
    return DataLoader(ds, _transform(cfg, training=False), batch_size=int(cfg.batch_size),
                      shuffle=False, drop_last=False, num_workers=int(cfg.get("workers", 8)),
                      group_by_shape=True, pin_memory=pin_memory)


def evaluate(state, loader, eval_pos_th, object_channel, use_ema=False, exporter=None,
             display_all=False, name="val_miou", save_vis_dir=None, device="cuda",
             hb: Heartbeat | None = None, metrics_log: MetricsLogger | None = None):
    """mIoU of ``state.model`` over ``loader`` (channel election, export, visualizations).

    Over several ranks every rank loads every batch, pads it to a multiple
    of the world size, runs its contiguous slice of rows and rebuilds the
    batch's probabilities (``gather_rows``); rank 0 alone writes the
    visualizations.
    """
    from .visualize import save_eval_visualization

    dev = resolve_device(device)
    size, rk = dist.world(), dist.rank()
    if not dist.is_main():
        save_vis_dir = None
    hb = hb or Heartbeat(None)
    eval_step = make_eval_step(use_ema=use_ema)
    evaluator = Evaluator(eval_pos_th=eval_pos_th, num_channels=state.model.mask_layer,
                          object_channel=object_channel, exporter=exporter)
    seen_sizes: set = set()
    t0, frames = time.perf_counter(), 0
    for batch in loader:
        size_key = (len(batch["imgs"]),) + tuple(batch["imgs"].shape[-3:-1])
        hb.beat(COMPILE_GRACE_S if size_key not in seen_sizes else DEFAULT_GRACE_S)
        seen_sizes.add(size_key)
        imgs_host = batch["imgs"][:, 0]  # [B, H, W, 3]
        if size == 1:
            probs = eval_step(state, imgs_host.to(dev, non_blocking=True))
        else:
            b_real = imgs_host.shape[0]
            pad_to = -(-b_real // size) * size
            imgs = torch.cat([imgs_host, imgs_host[:1].expand(pad_to - b_real,
                                                              *imgs_host.shape[1:])])
            per = pad_to // size
            local = eval_step(state, imgs[rk * per:(rk + 1) * per].to(dev, non_blocking=True))
            probs = dist.gather_rows(local, pad_to)[:b_real]
        frame_ids = [frame_id_from_path(p[0]) for p in batch["paths"]]
        evaluator.process_batch(probs, batch["ann"].to(dev, non_blocking=True),
                                batch["seq_names"], frame_ids)
        frames += len(frame_ids)
        if save_vis_dir is not None:
            # One visualization per batch, as rcf_model.py:241-308.
            vis_name = (f"eval_{batch['seq_names'][0]}_{int(batch['seq_ids'][0])}_"
                        f"{frame_ids[0]}_0000000")
            save_eval_visualization(save_vis_dir, vis_name, imgs_host[0].numpy(),
                                    probs[0].float().cpu().numpy())
    result = evaluator.finalize(display_all=display_all, name=name)
    logger.info(result.summary(name))
    if metrics_log is not None:
        metrics_log.log(**{f"{name}_frames": frames, f"{name}_s": time.perf_counter() - t0})
    return result


def _train_visualization(model, batch: dict, step_in: dict, out_dir: str, global_step: int):
    """The train grid of the step's first pair (rank 0's row 0 is the batch's row 0).

    Every rank runs the forward (its residual head's BatchNorm reduces over
    the ranks); rank 0 writes.
    """
    from .visualize import compose_train_grid, save_train_grid, vis_forward

    try:
        probs_v, flows_v = vis_forward(model, step_in["imgs"], step_in["gt_fw_flows"],
                                       step_in["gt_bw_flows"])
        if not dist.is_main():
            return
        flows_np = {k: (fw.float().cpu().numpy(), bw.float().cpu().numpy())
                    for k, (fw, bw) in flows_v.items()}
        pl = batch["pl_masks"].numpy() if "pl_masks" in batch else None
        grid = compose_train_grid(batch["imgs"].numpy(), probs_v.float().cpu().numpy(),
                                  flows_np, pl)
        frame_id = os.path.splitext(os.path.basename(batch["paths"][0][0]))[0]
        save_train_grid(out_dir, global_step, batch["seq_names"][0], frame_id, grid)
    except Exception as exc:  # as the reference: saving failures only warn
        logger.warning(f"train visualization failed: {exc!r}")


def _exporter(cfg, save_eval: str, save_export: str, object_channel):
    if not (cfg.get("eval_save") and cfg.get("eval_export")):
        return None
    return Exporter(save_eval, save_export, export_all_seg=bool(cfg.get("export_all_seg", False)),
                    object_channel=object_channel or 0, process_index=dist.rank(),
                    process_count=dist.world())


def _step_batch(batch: dict, dev: torch.device, rcf: bool, object_channel) -> dict:
    if not rcf:
        return {"imgs": batch["imgs"].to(dev, non_blocking=True)}
    out = {k: batch[k].to(dev, non_blocking=True) for k in _RCF_STEP_KEYS if k in batch}
    out["object_channel"] = object_channel if object_channel is not None else 0
    out["object_channel_set"] = object_channel is not None
    return out


def run(cfg, test_only: bool = False, no_test: bool = False, device: str = "cuda"):
    """Train and test as the config says (or test only); returns the test's
    ``EvalResult``, or the train state with ``no_test``."""
    dev = resolve_device(device)
    check_tpu_keys(cfg)
    pin = dev.type == "cuda"
    main_rank = dist.is_main()
    ckpt_dir = cfg.checkpoints_dir
    if main_rank:
        os.makedirs(ckpt_dir, exist_ok=bool(cfg.get("allow_overwriting_checkpoints_dir", True)))
    dist.barrier()
    hb = Heartbeat(ckpt_dir, host=dist.rank())
    hb.beat(COMPILE_GRACE_S)
    if main_rank:
        try:
            with open(os.path.join(ckpt_dir, "config_resolved.yaml"), "w") as f:
                f.write(yaml_subset.dump(cfg.to_dict()))
        except (OSError, TypeError) as exc:
            logger.warning(f"could not dump resolved config: {exc}")
    save_eval = os.path.join(ckpt_dir, cfg.get("saved_eval_dir_name", "saved_eval"))
    save_export = os.path.join(ckpt_dir, cfg.get("saved_eval_export_dir_name",
                                                 "saved_eval_export"))

    tpu_cfg = cfg.get("tpu") or {}
    cfg_dict = cfg.to_dict()
    seed = int(cfg.get("seed", 0))
    model = build_from_config(cfg, device=dev, seed=seed, dtype=compute_dtype(cfg_dict))
    rcf = cfg.get("model_cls", "RCFModel") == "RCFModel"

    pretrained = cfg.get("pretrained_model")
    restore_from, ema_override = None, None
    if pretrained:
        matches = globlib.glob(pretrained) if "*" in pretrained else [pretrained]
        if matches and os.path.isdir(matches[0]):
            restore_from = matches[0]  # the port's own checkpoint
        elif matches and os.path.exists(matches[0]):
            ema_override = load_pretrained(
                pretrained, model,
                backbone_only=bool(cfg.get("pretrained_model_backbone_only", False)),
                drop_decode_head2=bool(cfg.get("drop_head_decode_head2", False)))
        else:
            logger.warning(f"pretrained_model {pretrained} not found; using fresh init")

    head_cfg = cfg.model_kwargs.get("decode_head", {})
    if head_cfg.get("load_flownet", False):
        load_flownet(str(head_cfg["flow_model_path"]), model)

    if test_only:
        steps_per_epoch = 1
    else:
        train_loader = _build_loaders(cfg, training=True, pin_memory=pin)
        steps_per_epoch = max(len(train_loader), 1)

    state = create_train_state(cfg_dict, model, steps_per_epoch)
    if ema_override is not None:
        with torch.no_grad():
            own = model.state_dict()
            for k, v in ema_override.items():
                own[k].copy_(v)
    start_epoch, resumed = 0, False
    resume_dir = find_resumable(ckpt_dir)
    if not test_only and bool(cfg.get("auto_resume", True)) and resume_dir is not None:
        state = restore_checkpoint(resume_dir, state)
        start_epoch = state.step // max(steps_per_epoch, 1)
        resumed = True
        logger.info(f"auto-resume from {resume_dir}: step {state.step}, "
                    f"starting at epoch {start_epoch}")
    elif restore_from is not None:
        state = restore_checkpoint(restore_from, state, weights_only=True)
    dist.broadcast_state(state)  # every rank from rank 0's state (JAX's replicate)

    object_channel = cfg.get("object_channel")
    if object_channel is None and os.environ.get("OBJECT_CHANNEL"):
        object_channel = int(os.environ["OBJECT_CHANNEL"])
    if object_channel is None and resumed:
        object_channel = _load_object_channel(ckpt_dir)
        if object_channel is not None:
            logger.info(f"restored elected object channel {object_channel}")
    logger.info(f"Using {object_channel} as object channel")

    eval_on_ema = bool(cfg.get("eval_on_ema", False))
    metrics_log = MetricsLogger(ckpt_dir if main_rank else None)

    if test_only:
        vis_dir = save_eval if cfg.get("eval_save") else None
        return evaluate(state, _build_loaders(cfg, training=False, pin_memory=pin),
                        float(cfg.eval_pos_th), object_channel, use_ema=eval_on_ema,
                        exporter=_exporter(cfg, save_eval, save_export, object_channel),
                        display_all=True, name="test_miou", save_vis_dir=vis_dir, device=dev,
                        hb=hb, metrics_log=metrics_log)

    # ---------------- training ----------------
    train_step = make_train_step(crf_fn=maybe_crf_fn(model))
    vis_interval = int(cfg.model_kwargs.get("log_interval", 50))
    train_vis_dir = os.path.join(ckpt_dir, "saved")
    keeper = TopKKeeper(ckpt_dir, k=2)
    profiler = StepProfiler(tpu_cfg.get("profile_dir") if main_rank else None,
                            start=int(tpu_cfg.get("profile_start", 10)),
                            steps=int(tpu_cfg.get("profile_steps", 5)))
    generator = torch.Generator(device=dev)
    loss_log_interval = int(cfg.get("loss_log_interval", 100))
    set_after = int(cfg.get("set_object_channel_after_epoch", 1))
    val_every = int((cfg.get("trainer_kwargs") or {}).get("check_val_every_n_epoch", 1))
    epochs = int(cfg.get("override_max_epochs", cfg.epochs))
    ckpt_every = max(int(cfg.get("checkpoint_every_n_epochs", 1)), 1)

    global_step = start_epoch * steps_per_epoch
    compile_pending = True
    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        epoch_t0, frames = time.perf_counter(), 0
        batches = iter(train_loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            wait = time.perf_counter() - t0
            step_in = _step_batch(batch, dev, rcf, object_channel)
            generator.manual_seed(step_seed(seed, global_step))
            profiler.maybe_start(global_step)
            hb.beat(COMPILE_GRACE_S if compile_pending else DEFAULT_GRACE_S)
            losses = train_step(state, step_in, generator=generator)
            global_step += 1
            profiler.maybe_stop(global_step)
            compile_pending = False
            hb.beat()
            frames += int(batch["imgs"].shape[0] * batch["imgs"].shape[1]) * dist.world()
            if global_step % loss_log_interval == 0:
                vals = {k: float(v) for k, v in losses.items()}
                step_s = time.perf_counter() - t0 - wait
                if not np.isfinite(vals["loss"]):
                    raise RuntimeError(f"loss is NaN at step {global_step}: {vals}")
                logger.info(f"epoch {epoch} step {global_step}: " +
                            " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
                metrics_log.log(step=global_step, epoch=epoch, loader_wait_s=wait,
                                step_s=step_s, **{f"train_{k}": v for k, v in vals.items()})
            if rcf and vis_interval > 0 and global_step % vis_interval == 0:
                _train_visualization(model, batch, step_in, train_vis_dir, global_step)
        epoch_s = time.perf_counter() - epoch_t0
        metrics_log.log(epoch=epoch, train_epoch_s=epoch_s, train_frames=frames)
        logger.info(f"epoch {epoch} done in {epoch_s:.1f}s")

        if val_every > 0 and (epoch + 1) % val_every == 0:
            result = evaluate(state, _val_loader(cfg, pin_memory=pin), float(cfg.eval_pos_th),
                              object_channel, use_ema=eval_on_ema, device=dev, hb=hb,
                              metrics_log=metrics_log)
            if object_channel is None and epoch >= set_after - 1:
                object_channel = result.elected_channel
                logger.info(f"Set object channel to {object_channel} "
                            f"(channel distribution: {result.max_channel_freq})")
                if main_rank:
                    _save_object_channel(ckpt_dir, object_channel, epoch)
                compile_pending = True
            metrics_log.log(epoch=epoch, val_miou=result.miou,
                            val_miou_frame_avg=result.miou_frame_avg,
                            object_channel=object_channel)
            if (epoch + 1) % ckpt_every == 0 or epoch == epochs - 1:
                hb.beat(CKPT_GRACE_S)
                t_save = time.perf_counter()
                keeper.save(state, result.miou_frame_avg, tag=f"e{epoch}")
                metrics_log.log(epoch=epoch, checkpoint_s=time.perf_counter() - t_save)
                hb.beat()
        elif (epoch + 1) % ckpt_every == 0 or epoch == epochs - 1:
            # Validation off this epoch: still checkpoint `last` (main.py:434-436).
            hb.beat(CKPT_GRACE_S)
            t_save = time.perf_counter()
            save_checkpoint(ckpt_dir, "last", state)
            metrics_log.log(epoch=epoch, checkpoint_s=time.perf_counter() - t_save)
            hb.beat()

    if not no_test:
        test_vis_dir = os.path.join(ckpt_dir, "saved_eval_test") if cfg.get("eval_save") else None
        exporter = _exporter(cfg, os.path.join(ckpt_dir, "saved_eval_test"), save_export,
                             object_channel)
        return evaluate(state, _build_loaders(cfg, training=False, pin_memory=pin), -1.0,
                        object_channel, use_ema=eval_on_ema, exporter=exporter, display_all=True,
                        name="test_miou", save_vis_dir=test_vis_dir, device=dev, hb=hb,
                        metrics_log=metrics_log)
    return state
