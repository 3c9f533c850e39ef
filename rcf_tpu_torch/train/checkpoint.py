"""Checkpoints: save, rotate, resume, top-k, and torch-format imports (port
of ``rcf_tpu/train/checkpoint.py``).

Save side, as the reference's ModelCheckpoint policy (`main.py:434-436`):
every epoch, keep the top k=2 on the monitored metric plus ``last``. A
checkpoint is a directory ``<ckpt_dir>/<name>/`` holding one ``torch.save``
file, ``checkpoint.pt``::

    {"state_dict": {"model." + key: tensor},   # the model's state_dict keys
     "optimizer": optimizer.state_dict(), "step": int}

The port's state-dict keys are the reference's (``backbone2.*``,
``decode_head.*``, ``decode_head2.*``, ``decode_head3.*``, the ``*_ema``
copies), so the JAX package's ``load_pretrained`` imports the file as a
reference Lightning checkpoint, EMA included.

Restore side, the reference's dispatch (`main.py:76-142`), for files:

* reference Lightning checkpoints (``model.*``), with
  ``drop_head_decode_head2`` and ``pretrained_model_backbone_only``; the
  EMA copies when the file has them;
* MoCo v1/v2 (``module.encoder_q.*``, fc dropped);
* DenseCL / torchvision ResNets (``conv1.weight``) and ``backbone2.*``
  state dicts.

For the port these are key renames into its own ``state_dict``.

Over several ranks (``parallel/dist.py``) rank 0 alone writes, renames and
rotates; every rank waits at a barrier after each save, so no rank reads
``last`` while it moves, and every rank keeps the same top-k bookkeeping.
A checkpoint does not depend on the number of ranks that wrote it.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import shutil

import torch

from ..parallel import dist
from ..utils import get_logger

logger = get_logger()

CKPT_FILE = "checkpoint.pt"
EMA_PREFIXES = ("backbone2_ema.", "decode_head2_ema.")


def _payload(state) -> dict:
    return {
        "state_dict": {f"model.{k}": v.detach().cpu()
                       for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }


def _write(path: str, payload: dict) -> None:
    """Write ``<path>/checkpoint.pt`` through a scratch directory renamed into place."""
    partial = path + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(partial)
    torch.save(payload, os.path.join(partial, CKPT_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.rename(partial, path)


def save_checkpoint(ckpt_dir: str, name: str, state) -> str:
    """Save the train state under <ckpt_dir>/<name>.

    ``last`` is rotated, never overwritten in place: the new state goes to
    ``last.tmp``, then ``last`` -> ``last.prev`` and ``last.tmp`` ->
    ``last``, so at every instant one complete checkpoint exists among
    {last, last.tmp, last.prev} (``find_resumable``). Rank 0 writes; every
    rank returns after it has.
    """
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    if dist.is_main():
        _save(path, name, state)
    dist.barrier()
    return path


def _save(path: str, name: str, state) -> None:
    rotate = name == "last" and os.path.isdir(path)
    _write(path + ".tmp" if rotate else path, _payload(state))
    if rotate:
        prev = path + ".prev"
        shutil.rmtree(prev, ignore_errors=True)
        os.rename(path, prev)            # last -> last.prev (complete)
        os.rename(path + ".tmp", path)   # last.tmp -> last (complete)
    elif name == "last":
        # A stale last.tmp from an interrupted swap must not outlive this
        # newer checkpoint in find_resumable's order.
        shutil.rmtree(path + ".tmp", ignore_errors=True)


def find_resumable(ckpt_dir: str) -> str | None:
    """First complete `last`-family checkpoint: last, last.tmp (save finished
    but the swap was interrupted), then last.prev (fallback)."""
    for name in ("last", "last.tmp", "last.prev"):
        path = os.path.join(ckpt_dir, name)
        if os.path.isfile(os.path.join(path, CKPT_FILE)):
            return path
    return None


def read_checkpoint(path: str) -> dict:
    """A port checkpoint directory's payload, tensors on the CPU."""
    return torch.load(os.path.join(path, CKPT_FILE), map_location="cpu", weights_only=True)


def _is_ema(key: str) -> bool:
    return key.startswith(EMA_PREFIXES)


def _copy_into(model, tensors: dict) -> None:
    own = model.state_dict()
    with torch.no_grad():
        for k, v in tensors.items():
            if own[k].shape != v.shape:
                raise ValueError(f"shape mismatch importing {k}: {tuple(own[k].shape)} vs "
                                 f"{tuple(v.shape)}")
            own[k].copy_(v)


def _require(own_keys, src: dict, prefix: str) -> dict:
    """Every key of ``own_keys`` under ``prefix`` taken from ``src``; raises on a missing one."""
    keys = [k for k in own_keys if k.startswith(prefix)]
    missing = [k for k in keys if k not in src]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys of {prefix[:-1]}, e.g. {missing[:3]}")
    return {k: src[k] for k in keys}


def _resnet_take(own_keys, src: dict, prefix: str) -> dict:
    """A ResNet's tensors under ``prefix`` as JAX's ``import_resnet`` reads them:
    the 7x7 stem and every block's convs and BNs (a missing one raises), a
    block's downsample conv and BN where ``src`` has ``downsample.0.weight``
    (else they keep their init); a deep stem is not read."""
    keys = [k for k in own_keys if k.startswith(prefix) and not k.startswith(prefix + "stem.")]
    take, missing = {}, []
    for k in keys:
        block, sep, _ = k.partition(".downsample.")
        if sep and block + ".downsample.0.weight" not in src:
            continue
        if k in src:
            take[k] = src[k]
        else:
            missing.append(k)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys of {prefix[:-1]}, e.g. {missing[:3]}")
    return take


def restore_checkpoint(path: str, state, weights_only: bool = False):
    """Restore a train state from a port checkpoint directory.

    ``weights_only=True`` is the cross-stage init (``pretrained_model:
    <prev_stage>/last``): parameters, BN statistics and the EMA copies are
    taken; the step and the optimizer stay fresh, so the new stage's poly LR
    starts at its own base LR. When the checkpoint has no EMA and the model
    has one, the EMA is expanded from the restored weights (the reference's
    rule, `main.py:98-107`).
    """
    ckpt = read_checkpoint(path)
    sd = {k[len("model."):]: v for k, v in ckpt["state_dict"].items()}
    model = state.model
    own = model.state_dict()
    main = [k for k in own if not _is_ema(k)]
    missing = [k for k in main if k not in sd]
    if missing:
        raise KeyError(f"{path}: checkpoint lacks {len(missing)} model keys, e.g. {missing[:3]}")
    take = {k: sd[k] for k in main}
    has_ema = getattr(model, "has_ema", False)
    ckpt_ema = any(_is_ema(k) for k in sd)
    if has_ema and ckpt_ema:
        take.update(_require(own, sd, "backbone2_ema."))
        take.update(_require(own, sd, "decode_head2_ema."))
    _copy_into(model, take)
    if has_ema and not ckpt_ema:
        logger.info("checkpoint has no EMA; initializing the EMA from the main weights")
        model.copy_to_ema_()
    if not weights_only:
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
    return state


class TopKKeeper:
    """Keep the top-k checkpoints by metric plus `last` (main.py:434-436).

    The kept set (scores and names) persists to ``<ckpt_dir>/topk.json`` so
    that a resumed run keeps the top k over the whole run; entries whose
    directories were lost are dropped on load.
    """

    def __init__(self, ckpt_dir: str, k: int = 2):
        self.ckpt_dir = ckpt_dir
        self.k = k
        self.kept: list[tuple[float, str]] = []
        self._state_path = os.path.join(ckpt_dir, "topk.json")
        try:
            with open(self._state_path) as f:
                self.kept = [
                    (float(m), str(name)) for m, name in json.load(f)["kept"]
                    if os.path.isdir(os.path.join(ckpt_dir, str(name)))
                ]
        except (OSError, ValueError, KeyError):
            pass

    def _persist(self) -> None:
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"kept": self.kept}, f)
        os.replace(tmp, self._state_path)

    def save(self, state, metric: float, tag: str) -> None:
        save_checkpoint(self.ckpt_dir, "last", state)
        if len(self.kept) < self.k or metric > min(m for m, _ in self.kept):
            name = f"ckpt_{tag}_miou{metric:.4f}"
            save_checkpoint(self.ckpt_dir, name, state)
            self.kept.append((metric, name))
            self.kept.sort(key=lambda t: -t[0])
            evicted, self.kept = self.kept[self.k :], self.kept[: self.k]
            if dist.is_main():  # the bookkeeping above is the same on every rank
                for _, old in evicted:
                    shutil.rmtree(os.path.join(self.ckpt_dir, old), ignore_errors=True)
                self._persist()
            dist.barrier()


# ---------------------------------------------------------------------------
# Torch-format imports.
# ---------------------------------------------------------------------------


def load_flownet(path: str, model) -> None:
    """Load a PWC-Lite torch checkpoint into an AMD model's ``flownet``
    (reference `models/fcn_head.py:88-93`: ``torch.load(...)['state_dict']``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    logger.info(f"[Flownet] loading weights from {path}")
    own = {f"flownet.{k}" for k in model.flownet.state_dict()}
    _copy_into(model, _require(own, {f"flownet.{k}": v for k, v in sd.items()}, "flownet."))


def load_pretrained(path: str, model, backbone_only: bool = False,
                    drop_decode_head2: bool = False) -> dict | None:
    """Dispatch on the file's format and copy its weights into ``model``
    (main.py:76-142). Returns the file's EMA tensors (``backbone2_ema.*``,
    ``decode_head2_ema.*``) when it has them, else None: the caller puts
    them back after the train state has reset the EMA to the weights."""
    if "*" in path:
        matches = globlib.glob(path)
        if len(matches) != 1:
            raise ValueError(f"{matches} is not unique")
        path = matches[0]
    logger.info(f"Loading pretrained model from {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if backbone_only:
        sd = {k: v for k, v in sd.items() if "backbone" in k}
    example_key = next(iter(sd))
    own = model.state_dict()
    ema = None
    if example_key.startswith("model."):
        # Reference Lightning checkpoint (or the port's own file): the full RCF model.
        sub = {k[len("model."):]: v for k, v in sd.items()}
        if drop_decode_head2:
            sub = {k: v for k, v in sub.items() if "decode_head2" not in k}
        take = _resnet_take(own, sub, "backbone2.")
        for head in ("decode_head2.", "decode_head3.", "decode_head."):
            if any(k.startswith(head) for k in sub):
                take.update(_require(own, sub, head))
        if any(k.startswith("backbone2_ema.") for k in sub) and getattr(model, "has_ema", False):
            ema = _resnet_take(own, sub, "backbone2_ema.")
            if any(k.startswith("decode_head2_ema.") for k in sub):
                ema.update(_require(own, sub, "decode_head2_ema."))
    elif example_key.startswith("module."):
        moco = {f"backbone2.{k[len('module.encoder_q.'):]}": v for k, v in sd.items()
                if k.startswith("module.encoder_q.") and not k.startswith("module.encoder_q.fc")}
        take = _resnet_take(own, moco, "backbone2.")
    elif "conv1.weight" in sd:  # DenseCL / torchvision
        take = _resnet_take(own, {f"backbone2.{k}": v for k, v in sd.items()}, "backbone2.")
    elif "backbone2.conv1.weight" in sd:
        take = _resnet_take(own, sd, "backbone2.")
    else:
        raise ValueError(f"Unknown checkpoint format (first key: {example_key})")
    _copy_into(model, take)
    return ema
