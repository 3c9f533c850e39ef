"""The dense CRF's filter kernel (``csrc/crf.cu``) against its plain version, on the card.

Every case needs a card (``cuda`` marker) and skips without one. The file
imports no JAX, so that the card runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_crf_card.py

``crf_filter`` against ``crf_filter_plain`` on numpy features of synthetic
frames at a ragged N, the DAVIS grid and the sizes of ``RAGGED_SHAPES``, with
its launch count and ``STATS``; and on the five sets of
``kernel_sets.crf_filter_sets`` with TF32 switched on, against the plain
version and a float64 filter, each at the set's ``CRF_TOL``.
"""

from __future__ import annotations

import pytest
import torch

from rcf_tpu_torch.ops import crf_kernels as ck

import kernel_sets as ks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 2])
def test_crf_filter_kernel_matches_plain_on_card(cuda, d):
    """The kernel against its plain version at a ragged N and at the DAVIS grid."""
    for b, h, w in ((3, 97, 61), (16, 96, 96)):
        feat, vals = ks.filter_inputs(d, b, h, w)
        f, v = torch.from_numpy(feat).to(cuda), torch.from_numpy(vals).to(cuda)
        ck.reset_launch_counts()
        ours = ck.crf_filter(f, v)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["crf_filter"] == 1
        assert (ours - ck.crf_filter_plain(f, v)).abs().max() <= 1e-4, (b, h, w)


# N -> (images, h, w) of the card's ragged cases: below one tile (1, 7), one
# tile less one, exactly one, one more (the ragged rule in both directions),
# two tiles and 5, a ragged DAVIS-sized N, the DAVIS grid, and the
# SegTrackv2 stage-2.1 cell's 32 images of 128^2.
RAGGED_SHAPES = {1: (2, 1, 1), 7: (2, 1, 7), 255: (2, 15, 17), 256: (2, 16, 16),
                 257: (2, 1, 257), 2 * 256 + 5: (2, 11, 47), 97 * 61: (2, 97, 61),
                 96 * 96: (2, 96, 96), 128 * 128: (32, 128, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 2])
@pytest.mark.parametrize("n", sorted(RAGGED_SHAPES))
def test_crf_filter_kernel_matches_plain_at_ragged_sizes(cuda, d, n):
    """The kernel against its plain version at the sizes of ``RAGGED_SHAPES``, at
    the DAVIS scales (the split-TF32 logits: limit 2e-4, ``CRF_TOL``'s);
    ``STATS`` reads the schedule's logits after one launch (50.8% of the dense
    ones at the cell); a second call on the same inputs (the accumulator's
    adds in another order) stays within the limit of the first."""
    b, h, w = RAGGED_SHAPES[n]
    feat, vals = ks.filter_inputs(d, b, h, w)
    f, v = torch.from_numpy(feat).to(cuda), torch.from_numpy(vals).to(cuda)
    ck.reset_launch_counts()
    ours = ck.crf_filter(f, v)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["crf_filter"] == 1
    assert ck.STATS == {"pairs_evaluated": ck.schedule_pairs(b, n), "pairs_dense": b * n * n}
    if n == 128 * 128:
        assert round(ck.STATS["pairs_evaluated"] / ck.STATS["pairs_dense"], 3) == 0.508
    assert (ours - ck.crf_filter_plain(f, v)).abs().max() <= 2e-4
    again = ck.crf_filter(f, v)
    assert (again - ours).abs().max() <= 2e-4


@pytest.fixture
def tf32_on():
    """TF32 matmuls and convolutions on for the test (neither the kernel nor the
    plain version may depend on the switch), the switches restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ks.CRF_TOL))
def test_crf_filter_kernel_matches_plain_and_float64(cuda, tf32_on, name):
    """The set ``name`` of ``crf_filter_sets``: the kernel within ``CRF_TOL[name]``
    of the plain version and of a float64 filter."""
    feat, vals = ks.crf_filter_sets(torch.Generator(device=cuda).manual_seed(4))[name]
    ours = ck.crf_filter(feat, vals)
    to_plain = float((ours - ck.crf_filter_plain(feat, vals)).abs().max())
    to_f64 = float((ours - ks.crf_filter_f64(feat, vals)).abs().max())
    assert to_plain <= ks.CRF_TOL[name] and to_f64 <= ks.CRF_TOL[name], (to_plain, to_f64)
