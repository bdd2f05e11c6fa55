"""The page-copy kernel on the card (``cuda`` marker; each test skips where
``torch.cuda.is_available()`` is false), against its plain PyTorch version
byte for byte. This file imports no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_page_copy_cuda.py

Cases: the row sizes of the six main-path shapes (one layer's page of
whisper, paligemma, mistral and mixtral, recurrentgemma, int8 pages; N
cut) into the first or the last layer of a pool, int8 scale rows, whole
slots, unaligned rows, N = 1 and 10,000 tiny rows, with the index vectors
on the CPU and on the card; out-of-range pairs skipped; a wrapper call
with CPU index vectors and one layer's ``prefill_write`` with no host
synchronization (``torch.cuda.set_sync_debug_mode("error")``); a launch
captured in a CUDA graph and replayed.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import page_gather as pg
from repro_torch.kernels import plain_versions
from repro_torch.kernels.ref import page_copy_ref
from repro_torch.serving import engine
from repro_torch.serving import kvpool as kvp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


@contextlib.contextmanager
def no_host_sync():
    """Every synchronizing CUDA call in the block raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _bytes(rng, shape, dev):
    return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8)).to(
        dev)


def _pairs(rng, n, Sd, Ss):
    """``n`` pairs with unique destinations and about a tenth -1."""
    di = rng.permutation(max(Sd, n))[:n].astype(np.int32)
    di[di >= Sd] = -1
    si = rng.integers(0, Ss, n).astype(np.int32)
    si[rng.random(n) < 0.1] = -1
    return torch.as_tensor(di), torch.as_tensor(si)


def _held(dst, whole, src, di, si):
    """The kernel and the plain version on copies of the byte buffer
    ``whole`` (``dst`` a view into it): equal byte for byte."""
    off = dst.data_ptr() - whole.data_ptr()
    outs = []
    for fn in (pg.page_copy_cuda, page_copy_ref):
        buf = whole.clone()
        fn(buf.view(-1)[off:].as_strided(dst.shape, dst.stride()), src, di,
           si)
        torch.cuda.synchronize()
        outs.append(buf)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], whole)  # some pair copied


# One layer's page of the main paths (bytes) and N, cut.
MAIN = {"whisper": (192 * 1024, 32), "paligemma": (128 * 1024, 16),
        "mistral/mixtral": (512 * 1024, 12),
        "recurrentgemma": (128 * 1024, 16),
        "int8 pages": (256 * 1024, 12), "int8 scales": (1024, 192)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MAIN))
@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("on_card", [False, True])
def test_main_path_rows_match_plain(cuda_device, name, layer, on_card):
    R, n = MAIN[name]
    rng = np.random.default_rng(R + n)
    pool = _bytes(rng, (n + 4, 3, R), cuda_device)
    src = _bytes(rng, (n, R), cuda_device)
    di, si = _pairs(rng, n, n + 4, n)
    if on_card:
        di, si = di.to(cuda_device), si.to(cuda_device)
    _held(pool[:, layer], pool, src, di, si)


@pytest.mark.cuda
@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("R,n,odd", [
    (3 * 512 * 1024, 5, False),   # whole slots of a 3-layer pool
    (24 * 1024, 1, False),        # N = 1
    (17 * 1024, 3, False),        # chunks cut evenly, not 16 KiB
    (7, 9, False), (20_003, 4, True), (16 * 1024, 3, True),  # unaligned
    (16, 10_000, False), (48, 12_000, False),  # tiny rows
])
def test_odd_shapes_match_plain(cuda_device, on_card, R, n, odd):
    rng = np.random.default_rng(R + n)
    whole = _bytes(rng, ((n + 2) * (R + 1) + 1,), cuda_device)
    stride = R + 1 if odd else R
    dst = whole[int(odd):int(odd) + (n + 2) * stride].as_strided(
        (n + 2, R), (stride, 1))
    src = _bytes(rng, (n, R), cuda_device)
    di, si = _pairs(rng, n, n + 2, n)
    if on_card:
        di, si = di.to(cuda_device), si.to(cuda_device)
    _held(dst, whole, src, di, si)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1024, 128 * 1024, 100])
def test_out_of_range_pairs_skipped(cuda_device, R):
    """On the card an index out of range (either side, below -1 too)
    copies nothing; the other pairs land."""
    rng = np.random.default_rng(R)
    dst = _bytes(rng, (6, R), cuda_device)
    src = _bytes(rng, (4, R), cuda_device)
    di = torch.tensor([0, 6, 2, 3, 9, 5, -7], dtype=torch.int32)
    si = torch.tensor([1, 0, 4, -5, 2, 3, 0], dtype=torch.int32)
    got, want = dst.clone(), dst.clone()
    pg.page_copy_cuda(got, src, di.to(cuda_device), si.to(cuda_device))
    page_copy_ref(want, src, torch.tensor([0, 5]), torch.tensor([1, 3]))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_no_host_synchronization(cuda_device, kv_dtype):
    """A wrapper call with CPU index vectors, and one layer's prefill
    population (its indices moved to the card once, then both pools
    written), make no synchronizing call; the results are the plain
    version's."""
    rng = np.random.default_rng(5)
    dst = _bytes(rng, (40, 2, 64 * 1024), cuda_device)
    src = _bytes(rng, (32, 64 * 1024), cuda_device)
    di, si = _pairs(rng, 32, 40, 32)
    want = dst.clone()
    page_copy_ref(want[:, 0], src, di, si)
    pg.page_copy_cuda(dst[:, 1], src, di, si)  # builds and loads the library
    with no_host_sync():
        pg.page_copy_cuda(dst[:, 0], src, di, si)
        pg.page_copy(dst[:, 0], src, di.long(), si.long())
    torch.cuda.synchronize()
    assert torch.equal(dst[:, 0], want[:, 0])

    cfg = dataclasses.replace(ARCHS["mistral-nemo-12b"].reduced(), n_layers=2)
    sc = engine.ServeConfig(max_seq=64, batch_local=3, hbm_fraction=0.4,
                            kv_dtype=kv_dtype)
    spec = engine.make_kv_spec(cfg, sc)
    kv = kvp.init_paged_kv(spec, device=cuda_device)
    kv = kvp.prefill_residency(kv, spec, torch.full((3,), 64))
    k, v = (torch.as_tensor(rng.normal(size=(3, 64, spec.n_kv, spec.head_dim)),
                            dtype=torch.bfloat16, device=cuda_device)
            for _ in range(2))
    pools = kvp.pools_of(kv, spec)
    plain = [p.clone() for p in pools]
    with plain_versions():
        kvp.prefill_write(plain, kv, spec, 1, k, v)
    with no_host_sync():
        index = kvp.prefill_index(kv, 64 // spec.page_size, cuda_device)
        kvp.prefill_write(pools, kv, spec, 1, k, v, index)
    torch.cuda.synchronize()
    for p, q in zip(pools, plain):
        assert torch.equal(p.view(torch.uint8), q.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [96 * 1024, 1024])
def test_launch_in_a_cuda_graph(cuda_device, R):
    """With int32 indices on the card the launch is captured in a CUDA
    graph; each replay copies what the plain version copies."""
    rng = np.random.default_rng(9)
    dst = _bytes(rng, (20, 2, R), cuda_device)
    src = _bytes(rng, (16, R), cuda_device)
    di, si = (x.to(cuda_device) for x in _pairs(rng, 16, 20, 16))
    view = dst[:, 1]
    pg.page_copy_cuda(view, src, di, si)
    torch.cuda.synchronize()
    dst.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pg.page_copy_cuda(view, src, di, si)
    want = torch.zeros_like(dst)
    page_copy_ref(want[:, 1], src, di, si)
    for _ in range(2):
        dst.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(dst, want)
