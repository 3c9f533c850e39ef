"""DINO's linears (``rcf_tpu_torch/ops/linear_kernels.py``, ``csrc/linear.cu``).

On the CPU: the wrapper takes the plain version, which is ``F.linear``,
``F.gelu`` and ``+`` bit for bit (the whole ViT against its former forward:
``tests/test_torch_dino_attention.py``); it raises on an input that requires
grad and on mismatched shapes; a numpy model of the kernel's operands (the
split pass's layout, the fragments' order along K, x's swizzle in shared
memory) against float64; the wrapper's constants against the source.
The kernel itself runs only on the card (``cuda`` marker): against a float64
linear at the DINO cell's four shapes (M = 8 x 6,421) and at vit_base's
widths, with the GELU and residual epilogues, at ragged M (the sets of
``kernel_sets.LINEAR_SETS``), with the launch counts (one of each kernel a
call, 45 a vit_small/8 call) and its refusals. The file imports no JAX, so
that the card runs it (``python -m pytest --noconftest
tests/test_torch_dino_linear.py -m cuda``).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rcf_tpu_torch.nn import dino_vit
from rcf_tpu_torch.ops import linear_kernels as lk

import kernel_sets as ks

# The kernel's output against float64, as the largest |y - y64| over the
# largest |y64| of the call. Its products are f32 to ~2^-22 (split TF32, the
# model below), a slice's 12 products chained in the tensor cores and the
# slices summed in f32; a single TF32 product (10-bit mantissas) reads
# ~2^-11 here. Tighter than the attention's 3e-5 (KERNEL_TOL in
# tests/test_torch_dino_attention.py).
LINEAR_TOL = 1e-5


def _source() -> str:
    with open(os.path.join(lk.CSRC_DIR, "linear.cu")) as f:
        return f.read()


@pytest.mark.parametrize("gelu, residual", [(False, False), (False, True), (True, False),
                                            (True, True)])
def test_plain_is_the_former_linear_bit_for_bit(gelu, residual):
    """On the CPU: ``F.linear``, then ``F.gelu``, then ``residual +``, as the ViT ran them."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 37, 64), generator=g)
    w, b = torch.randn((96, 64), generator=g), torch.randn((96,), generator=g)
    r = torch.randn((2, 37, 96), generator=g) if residual else None
    lk.reset_launch_counts()
    ours = lk.dino_linear(x, w, b, gelu=gelu, residual=r)
    former = F.linear(x, w, b)
    if gelu:
        former = F.gelu(former, approximate="none")
    if residual:
        former = r + former
    assert torch.equal(ours, former)
    assert lk.LAUNCHES == {"dino_linear": 0, "dino_linear_split": 0}  # the CPU never launches


def test_raises_when_an_input_requires_grad():
    fc = torch.nn.Linear(64, 96)  # its parameters require grad
    x = torch.randn(1, 9, 64)
    with pytest.raises(ValueError, match="requires grad"):
        lk.dino_linear(x, fc.weight, fc.bias)
    with pytest.raises(ValueError, match="requires grad"):
        dino_vit.Mlp(64, 128)(x)
    with torch.no_grad():
        assert torch.equal(lk.dino_linear(x, fc.weight, fc.bias), fc(x))


def test_linear_modules_keep_their_names_and_hooks():
    """The ViT's linears are ``nn.Linear``s with the official state dict's names,
    called as modules: a forward hook on the last block's ``qkv`` (how the
    tools and the benchmark catch the keys) sees its output, whose middle third
    is the keys that ``return_last_k`` returns."""
    torch.manual_seed(5)
    vit = dino_vit.DinoViT(patch_size=8, embed_dim=64, depth=2, num_heads=2, train_grid=4).eval()
    assert all(isinstance(m, torch.nn.Linear) for m in (vit.blocks[0].attn.qkv, vit.blocks[0].mlp.fc1))
    assert {"blocks.1.attn.qkv.weight", "blocks.1.attn.proj.bias", "blocks.0.mlp.fc1.weight",
            "blocks.0.mlp.fc2.bias"} <= set(vit.state_dict())
    caught = []
    hook = vit.blocks[-1].attn.qkv.register_forward_hook(lambda m, args, out: caught.append(out))
    with torch.no_grad():
        keys = vit(torch.randn(2, 40, 48, 3), return_last_k=True)
    hook.remove()
    assert len(caught) == 1 and caught[0].shape == (2, 31, 192)
    assert torch.equal(caught[0][..., 64:128], keys)


def test_raises_on_mismatched_shapes():
    w, b = torch.zeros(96, 64), torch.zeros(96)
    with pytest.raises(ValueError, match="takes x"):
        lk.dino_linear(torch.zeros(3, 48), w, b)
    with pytest.raises(ValueError, match="takes x"):
        lk.dino_linear(torch.zeros(3, 64), w, torch.zeros(64))
    with pytest.raises(ValueError, match="residual"):
        lk.dino_linear(torch.zeros(3, 64), w, b, residual=torch.zeros(3, 64))


def test_wrapper_constants_are_the_kernel_source():
    """``ROWS``, ``COLS`` and ``SLICE`` are what ``csrc/linear.cu`` compiles, every
    admitted width is whole tiles and slices, and the scratch is the entry
    point's 8 N K bytes."""
    src = _source()
    consts = {name: re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
              for name in ("kWarps", "kRows", "kCols", "kSlice")}
    assert int(consts["kWarps"]) * 16 == lk.ROWS and consts["kRows"] == "16 * kWarps"
    assert (int(consts["kCols"]), int(consts["kSlice"])) == (lk.COLS, lk.SLICE)
    assert all(k % lk.SLICE == 0 for k in lk.IN_FEATURES)
    assert all(n % lk.COLS == 0 for n in lk.OUT_FEATURES)
    assert "8 n_out k bytes" in src
    assert lk.scratch_bytes(1536, 384) == 8 * 1536 * 384
    # Every DinoViT width: embed 384 and 768, MLP 4x, qkv 3x.
    for d in (384, 768):
        assert {d, 4 * d} <= set(lk.IN_FEATURES) and {d, 3 * d, 4 * d} <= set(lk.OUT_FEATURES)


def _tf32(x: np.ndarray) -> np.ndarray:
    """The kernel's ``tf32``: round to 10 mantissa bits, to nearest, ties away."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _weight_parts(w: np.ndarray) -> np.ndarray:
    """``split_weight``'s scratch as floats [N / COLS, K / SLICE, part (hi, lo),
    k-step, COLS x 8]: element (n, k) from the thread of row n and group k // 16,
    index by index as the kernel writes it."""
    n_out, k = w.shape
    steps = lk.SLICE // 8
    parts = np.zeros((n_out // lk.COLS, k // lk.SLICE, 2, steps, lk.COLS * 8), np.float32)
    n, kk = np.meshgrid(np.arange(n_out), np.arange(k), indexing="ij")
    q, v = kk // 16, kk % 16  # the thread's group of 16 and its register v[4j + 2e + half]
    j, e, half = v // 4, (v % 4) // 2, v % 2
    nr = n % lk.COLS
    off = (nr >> 3) * 64 + half * 32 + (nr & 7) * 4 + j  # bytes / 4 within the k-step
    hi = _tf32(w)
    for p, val in ((0, hi), (1, _tf32(w - hi))):
        parts[n // lk.COLS, q // (lk.SLICE // 16), p, 2 * (q % (lk.SLICE // 16)) + e, off] = val
    return parts


def _model_product(x: np.ndarray, w: np.ndarray, single: bool = False) -> np.ndarray:
    """x w^T as the kernel forms it, each TF32 product exact (float64): x's
    rows read as each thread's float4s (columns 4t .. 4t + 3 of group p), split
    into A fragments (k-step 2p + e: columns 4t + 2e and 4t + 2e + 1 of group p
    at t and t + 4); B read from the split pass's parts
    through wgmma's K-major descriptor (leading offset 128, stride 256 bytes);
    hi.hi + hi.lo + lo.hi (or hi.hi alone with ``single``)."""
    m, k = x.shape
    parts = _weight_parts(w).astype(np.float64)
    steps, rows = lk.SLICE // 8, np.arange(m)[:, None]
    t, kk = np.arange(4), np.arange(8)
    n = np.arange(w.shape[0])
    nr = n[:, None] % lk.COLS
    b_off = (nr >> 3) * 64 + (kk[None] >> 2) * 32 + (nr & 7) * 4 + (kk[None] & 3)
    out = np.zeros((m, w.shape[0]))
    for s in range(k // lk.SLICE):
        xs = x[:, s * lk.SLICE:(s + 1) * lk.SLICE].reshape(m, lk.SLICE // 4, 4)  # 16-byte chunks
        for ks in range(steps):
            p, e = divmod(ks, 2)
            v = xs[rows, 4 * p + t[None]]  # read_x: [m, t, 4]
            a = np.concatenate([v[:, :, 2 * e], v[:, :, 2 * e + 1]], axis=1)  # columns t, t + 4
            ah = _tf32(a).astype(np.float64)
            al = _tf32(a - _tf32(a)).astype(np.float64)
            bh, bl = (parts[n // lk.COLS, s, q][:, ks][np.arange(len(n))[:, None], b_off]
                      for q in (0, 1))  # [N, 8]
            out += ah @ bh.T if single else al @ bh.T + ah @ bl.T + ah @ bh.T
    return out


def test_split_tf32_products_hold_float32_accuracy_at_k1536():
    """The model of the kernel's operands at fc2's K = 1,536 against the float64
    product, over the sum of |products|: under 2^-21 (read 2^-23.4); one TF32
    product reads 2^-12.2, above 2^-15. A's order along K and B's disagreeing
    would read ~1."""
    rng = np.random.default_rng(1536)
    x = rng.standard_normal((40, 1536)).astype(np.float32)
    w = (rng.standard_normal((256, 1536)) / np.sqrt(1536)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64).T
    scale = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64).T
    assert np.max(np.abs(_model_product(x, w) - exact) / scale) < 2.0**-21
    assert np.max(np.abs(_model_product(x, w, single=True) - exact) / scale) > 2.0**-15


def test_fault_edits_apply_to_the_source():
    """Each fault ``tools/smoke_fault_check.py`` builds into linear.cu replaces
    text that occurs there exactly once."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "tools", "smoke_fault_check.py")
    spec = importlib.util.spec_from_file_location("smoke_fault_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = _source()
    assert set(mod.LINEAR_KERNEL_FAULTS) == {"linear_lo_dropped", "linear_tail_dropped"}
    for name, edits in mod.LINEAR_KERNEL_FAULTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)


@pytest.mark.parametrize("name", ["release", "diag_one_tf32", "diag_products_only",
                                  "diag_no_epilogue", "diag_no_split", "diag_no_sum"])
def test_variant_edits_apply_to_the_source(name):
    """Each design variant of ``tools/time_linear_variants.py`` is a set of text
    replacements, each of whose old texts occurs exactly once."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "tools", "time_linear_variants.py")
    spec = importlib.util.spec_from_file_location("time_linear_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert name in mod.VARIANTS
    src = text = _source()
    for old, new in mod.VARIANTS[name]:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    assert (text == src) == (name == "release"), name


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _check(name, cuda):
    args = ks.linear_inputs(name, cuda)
    lk.reset_launch_counts()
    with torch.no_grad():
        ours = lk.dino_linear(**args)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == {"dino_linear": 1, "dino_linear_split": 1}
    m, _, n, _, _ = ks.LINEAR_SETS[name]
    assert ours.shape == (m, n)
    assert ks.linear_gap(ours, args) <= LINEAR_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qkv", "proj", "fc1", "fc2"])
def test_kernel_matches_float64_at_the_cells_shapes(cuda, name):
    """The DINO cell's four linears at M = 8 x 6,421, with their epilogues."""
    _check(name, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["base_qkv", "base_fc1", "base_fc2"])
def test_kernel_matches_float64_at_vit_base_widths(cuda, name):
    """vit_base's widths (K 768 and 3,072; N 768, 2,304 and 3,072) at one frame."""
    _check(name, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [k for k in ks.LINEAR_SETS if k.startswith("ragged")])
def test_kernel_matches_float64_at_ragged_rows(cuda, name):
    """M under one tile, one short of a tile and a frame's 6,421 rows: the rows
    past M read row M - 1 and are not stored."""
    _check(name, cuda)


@pytest.mark.cuda
def test_vit_small_call_launches_45_times(cuda):
    """vit_small/8 at 480 x 856, keys of the last block: 11 blocks x 4 linears and
    the last block's qkv, one split pass and one product each; a ViT of depth 2
    makes 4 + 1."""
    from rcf_tpu_torch.utils.precision import full_f32

    gen = torch.Generator(device=cuda).manual_seed(11)
    vit = dino_vit.vit_small(patch_size=8, train_grid=28).to(cuda).eval()
    lk.reset_launch_counts()
    with torch.no_grad(), full_f32():
        vit(torch.rand((1, 480, 856, 3), generator=gen, device=cuda), return_last_k=True)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == {"dino_linear": 45, "dino_linear_split": 45}
    torch.manual_seed(2)
    vit = dino_vit.DinoViT(patch_size=8, embed_dim=384, depth=2, num_heads=6, train_grid=4)
    vit = vit.to(cuda).eval()
    lk.reset_launch_counts()
    with torch.no_grad():
        vit(torch.randn(2, 40, 48, 3, device=cuda), return_last_k=True)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == {"dino_linear": 5, "dino_linear_split": 5}


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, w, b = (torch.randn(s, device=cuda) for s in ((9, 384), (384, 384), (384,)))
    with pytest.raises(ValueError, match="compiled for K"):
        lk.dino_linear(torch.randn(9, 256, device=cuda), torch.randn(384, 256, device=cuda), b)
    with pytest.raises(ValueError, match="compiled for K"):
        lk.dino_linear(x, torch.randn(512, 384, device=cuda), torch.randn(512, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        lk.dino_linear(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        lk.dino_linear(torch.randn(384, 9, device=cuda).T, w, b)
    with pytest.raises(ValueError, match="requires grad"):
        lk.dino_linear(x.requires_grad_(True), w, b)
    with pytest.raises(ValueError, match="different devices"):
        lk.dino_linear(torch.randn(9, 384), w, b)
