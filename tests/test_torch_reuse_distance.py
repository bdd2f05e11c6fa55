"""The port's reuse-distance pass on the CPU against the reference.

- ``prev_occurrence`` (a numpy copy) equal to the reference's;
- the plain ``reuse_distances`` (``kernels/ref.reuse_distance_ref``, the
  CPU path) equal in every integer to ``repro.kernels.ref.
  reuse_distance_ref`` and to the Pallas ``reuse_distance_kernel`` in
  interpret mode, over the ``(seed, S, L, block)`` grid of
  ``test_reuse_distance.py``;
- shard segmentation: no distance leaks across rows or into pads.

The CUDA kernel against the plain version on the card is
``test_torch_reuse_distance_cuda.py`` (no JAX there).
"""
import numpy as np
import pytest
import torch

from repro.kernels import reuse_distance as J
from repro.kernels.ref import reuse_distance_ref as jax_ref
from repro_torch.kernels import reuse_distance as T
from repro_torch.kernels.ref import DIST_INF, reuse_distance_ref


def _ragged(rng, S, L, n_pages):
    """Random ragged shard rows (pads = repeats of the last page, like
    partition_streams)."""
    counts = rng.integers(0, L + 1, S)
    counts[rng.integers(0, S)] = L          # at least one full row
    sh_pages = rng.integers(0, n_pages, (S, L)).astype(np.int32)
    for s in range(S):
        if counts[s] < L:
            fill = sh_pages[s, counts[s] - 1] if counts[s] else 0
            sh_pages[s, counts[s]:] = fill
    return sh_pages, counts


def test_constants_match():
    assert DIST_INF == J.DIST_INF == T.DIST_INF


@pytest.mark.parametrize("seed", range(4))
def test_prev_occurrence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sh_pages, counts = _ragged(rng, S=4, L=97, n_pages=13)
    got = T.prev_occurrence(sh_pages, counts)
    want = J.prev_occurrence(sh_pages, counts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,S,L,block", [(2, 1, 16, 8), (3, 4, 100, 16),
                                            (4, 2, 128, 128), (5, 3, 37, 32)])
def test_plain_matches_reference_and_pallas(seed, S, L, block):
    """The plain version through the CPU dispatch equals the reference's
    pure-jax oracle and its Pallas kernel in interpret mode, bit for
    bit."""
    rng = np.random.default_rng(seed)
    sh_pages, counts = _ragged(rng, S=S, L=L, n_pages=11)
    prev, valid = J.prev_occurrence(sh_pages, counts)
    want = np.asarray(jax_ref(prev, valid, block=block))
    pallas = np.asarray(J.reuse_distance_kernel(prev, valid, block=block,
                                                interpret=True))
    got = T.reuse_distances(prev, valid, block=block, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("block", [1, 7, 128])
def test_plain_block_does_not_change_distances(block):
    """The query block is a blocking of the work, not of the result."""
    rng = np.random.default_rng(9)
    sh_pages, counts = _ragged(rng, S=3, L=150, n_pages=20)
    prev, valid = T.prev_occurrence(sh_pages, counts)
    want = np.asarray(jax_ref(prev, valid))
    got = reuse_distance_ref(torch.as_tensor(prev), torch.as_tensor(valid),
                             block=block)
    np.testing.assert_array_equal(got.numpy(), want)


def test_shard_segmentation_no_leaks():
    """A page ending one shard row and opening the next is a compulsory
    miss in the second row, and pads (edge-repeats) neither count toward
    gaps nor receive distances."""
    sh_pages = np.array([
        [5, 1, 2, 5, 5, 5],     # row 0: last real = page 5, then pads
        [5, 3, 5, 3, 3, 3],     # row 1 opens with page 5: must be INF
    ], np.int32)
    counts = np.array([4, 4])
    prev, valid = T.prev_occurrence(sh_pages, counts)
    d = T.reuse_distances(prev, valid, block=4, device="cpu").numpy()
    np.testing.assert_array_equal(d[0, :4], [DIST_INF, DIST_INF, DIST_INF, 2])
    np.testing.assert_array_equal(d[1, :4], [DIST_INF, DIST_INF, 1, 1])
    np.testing.assert_array_equal(d[:, 4:], -1)
    np.testing.assert_array_equal(
        d, np.asarray(J.reuse_distances(prev, valid, block=4)))


def test_first_accesses_and_pad_rows():
    """A row of first accesses only is all ``DIST_INF``; a row of pads
    only is all ``-1``; a first access inside a gap counts as a distinct
    page."""
    sh_pages = np.array([[0, 1, 2, 3, 4],
                         [7, 7, 7, 7, 7],
                         [1, 2, 1, 3, 2]], np.int32)
    counts = np.array([5, 0, 5])
    prev, valid = T.prev_occurrence(sh_pages, counts)
    d = T.reuse_distances(prev, valid, device="cpu").numpy()
    np.testing.assert_array_equal(d[0], DIST_INF)
    np.testing.assert_array_equal(d[1], -1)
    # page 2 at j=4: pages 1 and 3 (a first access) between -> 2
    np.testing.assert_array_equal(d[2], [DIST_INF, DIST_INF, 1, DIST_INF, 2])
    np.testing.assert_array_equal(d, np.asarray(jax_ref(prev, valid)))


def test_numpy_inputs_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev, valid = T.prev_occurrence(np.zeros((1, 4), np.int32), [4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.reuse_distances(prev, valid)
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.reuse_distance_cuda(torch.as_tensor(prev), torch.as_tensor(valid))
