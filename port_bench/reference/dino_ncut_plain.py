"""The plain reference of ``dino_vits8_f32``: DINO ViT-S/8 keys and the soft
NCut refinement of RCF's semantic constraint, in plain torch float32.

Written from the sources and not from ``rcf_tpu_torch``: DINO (Caron et al.,
arXiv:2104.14294; facebookresearch/dino ``vision_transformer.py``, ``vit_small``
with patch 8) and RCF's stage-2.2 tool (arXiv:2304.08025 section 3.3;
``tools/SemanticConstraintsAndMAA/semantic_constraints.py``). One frame at a
time (a 6,422-token frame's scores are 0.99 GB a block), both TF32 switches
off unless a control asks for TF32.

* frames: RGB in [0, 1], ImageNet-normalised, resized bilinearly to the
  tool's 480 x 856 (``F.interpolate``, no antialias);
* the ViT: the patch embedding (a stride-8 convolution), the CLS token, the
  position embeddings resized as DINO's ``interpolate_pos_encoding`` does
  (bicubic, scale factor (h0 + 0.1) / 28 and (w0 + 0.1) / 28), then
  pre-norm blocks (LayerNorm eps 1e-6; attention as product, softmax,
  product; exact-GELU MLP); the keys are the last block's ``qkv`` output's
  key third, as the tool's forward hook on ``blocks[-1].attn.qkv`` reads
  them, so the last block runs no attention;
* the affinity: ``(f f^T > tau) ? 1 : eps`` over the L2-normalised patch keys
  (the CLS key dropped);
* the mask at the feature grid: ``F.interpolate`` nearest;
* NCut(x) = cut(x, 1 - x) / assoc(x, V) + cut(x, 1 - x) / assoc(1 - x, V);
* the refinement: ``torch.optim.Adam(lr=0.45, weight_decay=1e-6)`` on the
  mask for 10 steps, the mask clamped to [0, 1] after each, as RCF's tool.

Also the work the benchmark counts from shapes: ``frame_flops`` and the
attention's floor (``attention_work``), and the seeded weights at DINO's
initialisation (``make_weights``), which the program and this reference
both take.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _arch(arch: dict) -> tuple[int, int, int, int, int, int, float]:
    return (int(arch["patch_size"]), int(arch["embed_dim"]), int(arch["depth"]), int(arch["num_heads"]),
            int(arch["mlp_hidden_dim"]), int(arch["pos_grid"]), float(arch["layer_norm_eps"]))


# ---------------------------------------------------------------------------
# Weights at DINO's initialisation
# ---------------------------------------------------------------------------


def weight_specs(arch: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every tensor, in the official state dict's names.
    ``trunc``: trunc-normal std 0.02 on [-2, 2] (DINO's Linear weights,
    ``pos_embed``, ``cls_token``); ``conv``: PyTorch's default Conv2d
    initialisation, which DINO leaves to the patch embedding (uniform on
    +-1/sqrt(fan_in), weight and bias); ``zeros``, ``ones``."""
    p, d, depth, _, m, grid, _ = _arch(arch)
    out = [("cls_token", (1, 1, d), "trunc"), ("pos_embed", (1, grid * grid + 1, d), "trunc"),
           ("patch_embed.proj.weight", (d, 3, p, p), "conv"), ("patch_embed.proj.bias", (d,), "conv")]
    for i in range(depth):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "ones"), (b + "norm1.bias", (d,), "zeros"),
                (b + "attn.qkv.weight", (3 * d, d), "trunc"), (b + "attn.qkv.bias", (3 * d,), "zeros"),
                (b + "attn.proj.weight", (d, d), "trunc"), (b + "attn.proj.bias", (d,), "zeros"),
                (b + "norm2.weight", (d,), "ones"), (b + "norm2.bias", (d,), "zeros"),
                (b + "mlp.fc1.weight", (m, d), "trunc"), (b + "mlp.fc1.bias", (m,), "zeros"),
                (b + "mlp.fc2.weight", (d, m), "trunc"), (b + "mlp.fc2.bias", (d,), "zeros")]
    return out + [("norm.weight", (d,), "ones"), ("norm.bias", (d,), "zeros")]


def make_weights(arch: dict, seed: int, device) -> dict:
    """Every tensor from one generator seeded with ``seed``, in ``weight_specs``'s order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fan_in = 3 * int(arch["patch_size"]) ** 2
    out = {}
    for name, shape, init in weight_specs(arch):
        if init == "trunc":
            # Inverse CDF of the normal on [cdf(-2 / 0.02), cdf(2 / 0.02)] = (0, 1).
            u = torch.rand(shape, generator=gen, device=device).clamp(1e-7, 1 - 1e-7)
            out[name] = (0.02 * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
        elif init == "conv":
            bound = 1.0 / math.sqrt(fan_in)
            out[name] = (2.0 * torch.rand(shape, generator=gen, device=device) - 1.0) * bound
        else:
            out[name] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return out


# ---------------------------------------------------------------------------
# The ViT's keys
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Both TF32 switches set to ``tf32`` inside the block, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _pos_embed(w: dict, h0: int, w0: int, arch: dict) -> torch.Tensor:
    _, d, _, _, _, n, _ = _arch(arch)
    pe = w["pos_embed"]
    if (h0, w0) == (n, n):
        return pe
    grid = pe[:, 1:].reshape(1, n, n, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((h0 + 0.1) / n, (w0 + 0.1) / n), mode="bicubic",
                         align_corners=False)
    assert tuple(grid.shape[-2:]) == (h0, w0), grid.shape
    return torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, h0 * w0, d)], dim=1)


def frame_keys(w: dict, img01: torch.Tensor, arch: dict, resize: tuple[int, int],
               drop_head: int | None = None) -> torch.Tensor:
    """One frame [H, W, 3] in [0, 1] -> the last block's keys [N + 1, D]. ``drop_head``
    (a control): that head's attention output left out of every block."""
    p, d, depth, heads, _, _, eps = _arch(arch)
    hd = d // heads
    mean = torch.tensor(MEAN, device=img01.device)
    std = torch.tensor(STD, device=img01.device)
    x = ((img01.float() - mean) / std).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=tuple(resize), mode="bilinear", align_corners=False)
    x = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"], stride=p)
    h0, w0 = x.shape[-2:]
    x = torch.cat([w["cls_token"], x.flatten(2).transpose(1, 2)], dim=1) + _pos_embed(w, h0, w0, arch)
    n = x.shape[1]
    for i in range(depth):
        b = f"blocks.{i}."
        y = F.layer_norm(x, (d,), w[b + "norm1.weight"], w[b + "norm1.bias"], eps)
        qkv = F.linear(y, w[b + "attn.qkv.weight"], w[b + "attn.qkv.bias"])
        q, k, v = qkv.reshape(n, 3, heads, hd).permute(1, 2, 0, 3)     # [heads, N, hd] each
        if i == depth - 1:
            return k.transpose(0, 1).reshape(n, d)
        o = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1) @ v
        if drop_head is not None:
            o = torch.cat([o[:drop_head], torch.zeros_like(o[:1]), o[drop_head + 1:]])
        x = x + F.linear(o.transpose(0, 1).reshape(1, n, d), w[b + "attn.proj.weight"], w[b + "attn.proj.bias"])
        y = F.layer_norm(x, (d,), w[b + "norm2.weight"], w[b + "norm2.bias"], eps)
        y = F.linear(F.gelu(F.linear(y, w[b + "mlp.fc1.weight"], w[b + "mlp.fc1.bias"])),
                     w[b + "mlp.fc2.weight"], w[b + "mlp.fc2.bias"])
        x = x + y
    raise ValueError("depth must be at least 1")


# ---------------------------------------------------------------------------
# The soft NCut
# ---------------------------------------------------------------------------


def affinity(keys: torch.Tensor, tau: float, eps: float) -> torch.Tensor:
    """keys [N + 1, D] -> [N, N]: 1 where the cosine of two patch keys exceeds tau, else eps."""
    f = F.normalize(keys[1:].float(), dim=-1)
    return torch.where(f @ f.T > tau, 1.0, eps)


def ncut_value(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = mask.reshape(-1)
    degree = a.sum(dim=1)
    cut = x @ (a @ (1.0 - x))
    return cut / (x @ degree) + cut / ((1.0 - x) @ degree)


def refine(a: torch.Tensor, grid_mask: torch.Tensor, steps: int, lr: float, weight_decay: float) -> torch.Tensor:
    m = grid_mask.detach().clone().float().requires_grad_(True)
    opt = torch.optim.Adam([m], lr=lr, weight_decay=weight_decay)
    for _ in range(steps):
        opt.zero_grad()
        ncut_value(a, m).backward()
        opt.step()
        with torch.no_grad():
            m.clamp_(0.0, 1.0)
    return m.detach()


def semantic_refine(w: dict, imgs01: torch.Tensor, masks: torch.Tensor, cfg: dict, tf32: bool = False,
                    drop_head: int | None = None, steps: int | None = None) -> dict:
    """The semantic constraint's device stage, frame by frame: imgs01 [B, H, W, 3],
    masks [B, H, W] -> {"keys" [B, N + 1, D], "grid" [B, h, w] (the mask at the
    feature grid), "refined" [B, h, w], "ncut_before" [B], "ncut_after" [B]}.
    Controls: ``tf32``, ``drop_head``, ``steps``."""
    arch, nc = cfg["arch"], cfg["ncut"]
    steps = int(nc["steps"]) if steps is None else steps
    out: dict = {k: [] for k in ("keys", "grid", "refined", "ncut_before", "ncut_after")}
    with precision(tf32):
        gh, gw = (s // int(arch["patch_size"]) for s in cfg["resize"])
        grids = F.interpolate(masks.float()[:, None], size=(gh, gw), mode="nearest")[:, 0]
        for img, grid in zip(imgs01, grids):
            with torch.no_grad():
                keys = frame_keys(w, img, arch, cfg["resize"], drop_head)
                a = affinity(keys, float(nc["tau"]), float(nc["eps"]))
            refined = refine(a, grid, steps, float(nc["learning_rate"]), float(nc["weight_decay"]))
            with torch.no_grad():
                out["ncut_before"].append(ncut_value(a, grid))
                out["ncut_after"].append(ncut_value(a, refined))
            out["keys"].append(keys)
            out["grid"].append(grid)
            out["refined"].append(refined)
            del a
    return {k: torch.stack(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# The work, from shapes
# ---------------------------------------------------------------------------


def tokens(cfg: dict) -> int:
    """Tokens a frame: the patch grid at the tool's resize and the CLS token."""
    p = int(cfg["arch"]["patch_size"])
    return (cfg["resize"][0] // p) * (cfg["resize"][1] // p) + 1


def frame_flops(n_tokens: int, arch: dict) -> float:
    """Model FLOPs of one frame (2 a multiply-add): the patch embedding, the
    ``depth - 1`` blocks that run attention (qkv, Q K^T, A V, proj, MLP), the
    last block's qkv, and the affinity's Gram matrix over the patch keys.
    LayerNorms, softmax, GELU and the NCut's matrix-vector products (about
    0.3% of the total at 480 x 856) are left out."""
    p, d, depth, _, m, _, _ = _arch(arch)
    n, patches = n_tokens, n_tokens - 1
    embed = 2.0 * patches * 3 * p * p * d
    block = 2.0 * n * d * 3 * d + 4.0 * n * n * d + 2.0 * n * d * d + 4.0 * n * d * m
    return embed + (depth - 1) * block + 2.0 * n * d * 3 * d + 2.0 * patches * patches * d


def attention_work(n_tokens: int, arch: dict) -> dict:
    """One block's attention over one frame, for the floor of
    ``kernels.dino_attention_roofline_pct``: the FLOPs of Q K^T and A V, the
    heads x N^2 exponentials of the softmax, and the bytes of q, k, v and o in
    float32, each read or written once."""
    _, d, _, heads, _, _, _ = _arch(arch)
    n = n_tokens
    return {"flops": 4.0 * n * n * d, "exps": float(heads) * n * n, "bytes": 4.0 * 4 * n * d}
