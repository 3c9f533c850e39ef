"""DINO's attention (``rcf_tpu_torch/ops/attention_kernels.py``, ``csrc/attention.cu``).

On the CPU: the wrapper takes the plain version, which is the ViT's former
three-step attention bit for bit (alone, in ``Attention.forward`` and through
a whole ``DinoViT``, whose holds against the JAX package are
``tests/test_torch_grouping.py``'s); it raises on an input that requires
grad; a numpy model of the kernel's split-TF32 products against float64.
The kernel itself runs only on the card (``cuda`` marker): against a float64
attention at one frame of the cell (6 heads of 64, 6,421 tokens) and at
``moco_vit_small``'s head dim 32 (12 heads, 1,591 tokens at 480 x 856), at
ragged N, with the launch count, and its refusals. The file imports no JAX,
so that the card runs it (``python -m pytest --noconftest
tests/test_torch_dino_attention.py -m cuda``).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from rcf_tpu_torch.nn import dino_vit
from rcf_tpu_torch.ops import attention_kernels as ak

# The kernel's output against float64, as the largest |o - o64| over the
# largest |o64| of the call. Its products are f32 to ~2^-22 (split TF32, the
# model below) and its sums f32; a single TF32 product (10-bit mantissas)
# reads ~5e-4 here, which moves the cell's keys past their 3e-5 limit.
KERNEL_TOL = 3e-5


def _former_attention(qkv: torch.Tensor) -> torch.Tensor:
    """``Attention.forward``'s attention as the ViT ran it before the kernel."""
    b, n, _, heads, hd = qkv.shape
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, heads, N, hd]
    attn = torch.softmax((q @ k.transpose(-2, -1)) * (hd ** -0.5), dim=-1)
    out = attn @ v
    return out.transpose(1, 2).reshape(b, n, heads * hd)


def _former_forward(self, x, return_k=False, span=None):
    b, n, d = x.shape
    qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, d // self.num_heads)
    if return_k:
        return qkv[:, :, 1].reshape(b, n, d)
    return self.proj(_former_attention(qkv))


def _qkv(b, n, heads, hd, scale=1.0, seed=0, device="cpu", pad_tokens=0):
    """A [b, n, 3, heads, hd] view of a linear-like output [b, n + pad, 3 heads hd]:
    i.i.d. N(0, scale^2), the image stride past the view's tokens when padded."""
    g = torch.Generator().manual_seed(seed)
    full = torch.randn((b, n + pad_tokens, 3 * heads * hd), generator=g) * scale
    return full.to(device)[:, :n].reshape(b, n, 3, heads, hd)


@pytest.mark.parametrize("b, n, heads, hd", [(2, 37, 2, 32), (1, 65, 6, 64), (3, 1, 1, 16)])
def test_plain_is_the_former_attention_bit_for_bit(b, n, heads, hd):
    qkv = _qkv(b, n, heads, hd, scale=2.0)
    out = ak.dino_attention(qkv)
    assert out.shape == (b, n, heads * hd)
    assert torch.equal(out, _former_attention(qkv))
    assert ak.LAUNCHES["dino_attention"] == 0  # the CPU never launches


def test_vit_forward_is_the_former_bit_for_bit(monkeypatch):
    """A depth-3 ViT (2 heads of 32) through the wrapper, keys and tokens, equal
    to the same ViT with the former ``Attention.forward``."""
    torch.manual_seed(1)
    vit = dino_vit.DinoViT(patch_size=8, embed_dim=64, depth=3, num_heads=2, train_grid=4).eval()
    imgs = torch.randn(2, 40, 48, 3)
    with torch.no_grad():
        ours = vit(imgs), vit(imgs, return_last_k=True)
        monkeypatch.setattr(dino_vit.Attention, "forward", _former_forward)
        former = vit(imgs), vit(imgs, return_last_k=True)
    assert all(torch.equal(a, b) for a, b in zip(ours, former))


def test_raises_when_an_input_requires_grad():
    qkv = _qkv(1, 9, 2, 32).requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        ak.dino_attention(qkv)
    attn = dino_vit.Attention(64, 2)
    with pytest.raises(ValueError, match="requires grad"):
        attn(torch.randn(1, 9, 64))  # grad mode on: the qkv linear's output requires grad


def test_raises_on_a_shape_that_is_not_qkv():
    with pytest.raises(ValueError, match="qkv must be"):
        ak.dino_attention(torch.zeros(1, 9, 2, 2, 32))


def _tf32(x: np.ndarray) -> np.ndarray:
    """The kernel's ``tf32``: round to 10 mantissa bits, to nearest, ties away."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("hd", [32, 64])
def test_split_tf32_products_hold_float32_accuracy(hd):
    """The kernel's dot of two split operands (hi.hi + hi.lo + lo.hi, each TF32
    product exact, summed in float64 here) against the float64 dot, over the sum
    of |products|: read 2^-23.6 (hd 32) and 2^-24.1 (hd 64), limit 2^-21; one
    TF32 product reads 2^-11.9 and 2^-12.4, above 2^-15."""
    rng = np.random.default_rng(hd)
    a = rng.standard_normal((512, hd)).astype(np.float32)
    b = rng.standard_normal((512, hd)).astype(np.float32)
    exact = np.einsum("ij,ij->i", a.astype(np.float64), b.astype(np.float64))
    scale = np.einsum("ij,ij->i", np.abs(a).astype(np.float64), np.abs(b).astype(np.float64))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    assert np.all(np.abs(a - ah - al) <= np.abs(a) * 2.0**-21)
    split = sum(np.einsum("ij,ij->i", x.astype(np.float64), y.astype(np.float64))
                for x, y in ((al, bh), (ah, bl), (ah, bh)))
    single = np.einsum("ij,ij->i", ah.astype(np.float64), bh.astype(np.float64))
    assert np.max(np.abs(split - exact) / scale) < 2.0**-21
    assert np.max(np.abs(single - exact) / scale) > 2.0**-15


def test_wrapper_constants_are_the_kernel_source():
    """``KEYS`` and ``HEAD_DIMS`` are what ``csrc/attention.cu`` compiles."""
    with open(os.path.join(os.path.dirname(ak.__file__), "..", "csrc", "attention.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kKeys = (\d+);", src).group(1)) == ak.KEYS
    cases = sorted(int(c) for c in re.findall(r"case (\d+):\s*return launch<", src))
    assert tuple(cases) == ak.HEAD_DIMS
    # The scratch: 4 parts x KEYS x hd x 4 bytes a tile (the entry point's comment).
    assert ak.scratch_bytes(8, 6421, 6, 64) == 8 * 6 * 201 * 512 * 64


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _gap(ours: torch.Tensor, qkv: torch.Tensor) -> float:
    ref = ak.dino_attention_plain(qkv.double())
    return float((ours.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b, n, heads, hd", [(1, 6421, 6, 64), (1, 1591, 12, 32)])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_kernel_matches_float64_at_the_tools_shapes(cuda, b, n, heads, hd, scale):
    """One frame of the cell (vit_small/8 at 480 x 856) and moco_vit_small/16's
    head dim; ``scale`` 2 makes the scores' spread 4 (sharper weights)."""
    qkv = _qkv(b, n, heads, hd, scale=scale, seed=n, device=cuda)
    ak.reset_launch_counts()
    with torch.no_grad():
        ours = ak.dino_attention(qkv)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["dino_attention"] == 1
    assert _gap(ours, qkv) <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("n", [1, 63, 65, 129])
def test_kernel_matches_float64_at_ragged_sizes(cuda, hd, n):
    """N under a key tile, around one query warpgroup (64) and one block (128):
    the masked key tail and the unstored query rows; the image stride past the
    view (3 padding tokens) and two images of 3 heads."""
    qkv = _qkv(2, n, 3, hd, scale=2.0, seed=n + hd, device=cuda, pad_tokens=3)
    assert not qkv.is_contiguous()
    with torch.no_grad():
        ours = ak.dino_attention(qkv)
    torch.cuda.synchronize()
    assert _gap(ours, qkv) <= KERNEL_TOL


@pytest.mark.cuda
def test_launches_count_one_a_call_and_one_a_block(cuda):
    """One launch a call; a ViT of depth 4 makes 3 (its last block gives keys)."""
    qkv = _qkv(2, 70, 2, 32, device=cuda)
    ak.reset_launch_counts()
    with torch.no_grad():
        for _ in range(3):
            ak.dino_attention(qkv)
    assert ak.LAUNCHES["dino_attention"] == 3
    torch.manual_seed(2)
    vit = dino_vit.DinoViT(patch_size=8, embed_dim=64, depth=4, num_heads=2, train_grid=4)
    vit = vit.to(cuda).eval()
    ak.reset_launch_counts()
    with torch.no_grad():
        vit(torch.randn(2, 40, 48, 3, device=cuda), return_last_k=True)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["dino_attention"] == 3


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="head dims"):
        ak.dino_attention(_qkv(1, 9, 2, 48, device=cuda))
    with pytest.raises(ValueError, match="head dims"):
        ak.dino_attention(_qkv(1, 9, 2, 16, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        ak.dino_attention(_qkv(1, 9, 2, 32, device=cuda).double())
    with pytest.raises(ValueError, match="strides"):
        ak.dino_attention(_qkv(1, 9, 2, 32, device=cuda).transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError, match="requires grad"):
        ak.dino_attention(_qkv(1, 9, 2, 32, device=cuda).requires_grad_(True))


def test_variant_edits_apply_to_the_source():
    """Each design variant of ``tools/time_attention_variants.py`` is a set of
    text replacements, each of whose old texts occurs exactly once."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "tools", "time_attention_variants.py")
    spec = importlib.util.spec_from_file_location("time_attention_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(os.path.dirname(ak.__file__), "..", "csrc", "attention.cu")) as f:
        src = f.read()
    for name, edits in mod.VARIANTS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text == src) == (name == "release"), name
