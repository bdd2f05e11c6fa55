"""The redesigned page-copy kernel's work split, emulated on the CPU.

``csrc/page_copy.cu`` runs only on the card. Here its plan
(``page_gather.copy_plan``: the path by alignment and row size, the chunk,
the grid) and the loops of its two paths run in numpy over flat byte
buffers that hold strided pools: each block's walk over (pair, chunk)
items with a grid-stride loop, and each thread's 16-byte vectors (the
vector path) or bytes (the bytes path).

The result is held against ``page_copy_ref`` and the JAX reference's
``repro.kernels.ref.page_copy_ref`` (exact), every live byte is written
exactly once and every other byte is unchanged. Cases: the main paths'
shapes with N cut, and cases drawn by hypothesis (derandomized): rows of
1 B to 1 MiB, unaligned bases and sizes, one-layer strided views, -1 and
out-of-range pairs (the kernel skips them: the references see them as
-1), N from 0 to 300. The CPU wrapper's results and its ``IndexError``
stay as they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import page_gather as tpg
from repro_torch.kernels import ref as tref

H100_SMS = 132
_JREF = jax.jit(jref.page_copy_ref)


class Pools:
    """``Sd`` destination and ``Ss`` source rows of ``R`` bytes in two flat
    byte buffers: row ``i`` of dst at ``d_off + i * d_stride`` (one layer
    of a pool when the stride spans several rows), of src likewise."""

    def __init__(self, rng, R, Sd, Ss, d_off, d_stride, s_off, s_stride):
        self.R, self.Sd, self.Ss = R, Sd, Ss
        self.d_off, self.d_stride = d_off, d_stride
        self.s_off, self.s_stride = s_off, s_stride
        self.dst = rng.integers(0, 256, d_off + (Sd - 1) * d_stride + R + 16,
                                dtype=np.uint8)
        self.src = rng.integers(0, 256, s_off + (Ss - 1) * s_stride + R + 16,
                                dtype=np.uint8)

    def align(self) -> int:
        return self.d_off | self.s_off | self.d_stride | self.s_stride

    def view(self, buf, off, stride, rows):
        return torch.as_tensor(buf).as_strided((rows, self.R), (stride, 1),
                                               off)

    def rows_of(self, buf, off, stride, rows):
        return np.lib.stride_tricks.as_strided(
            buf[off:], (rows, self.R), (stride, 1)).copy()


def emulate(plan: tpg.CopyPlan, pools: Pools, di, si):
    """The kernel's loops for ``plan``: returns (dst buffer after, writes
    per byte of it)."""
    out = pools.dst.copy()
    writes = np.zeros(len(out), np.int64)
    puts = [0]  # bytes put: more than the writes counted if a put repeats
    n, R, T = len(di), pools.R, tpg.THREADS

    def live(p):
        return 0 <= di[p] < pools.Sd and 0 <= si[p] < pools.Ss

    def put(p, offs):
        d = pools.d_off + int(di[p]) * pools.d_stride + offs
        s = pools.s_off + int(si[p]) * pools.s_stride + offs
        out[d] = pools.src[s]
        writes[d] += 1
        puts[0] += len(d)

    def vectors(nv):
        # Vector v = thread + T * (unroll step + UNROLL * round).
        rounds = -(-nv // (T * tpg.UNROLL))
        v = (np.arange(T)[:, None, None]
             + T * tpg.UNROLL * np.arange(rounds)[None, :, None]
             + T * np.arange(tpg.UNROLL)[None, None, :]).ravel()
        return v[v < nv]

    def walk(b):
        for it in range(b, n * plan.chunks, plan.blocks):
            p, c = divmod(it, plan.chunks)
            if live(p):
                lo = c * plan.chunk
                yield p, lo, min(lo + plan.chunk, R)

    for b in range(plan.blocks):
        for p, lo, hi in walk(b):
            if plan.path == "bytes":
                offs = lo + (np.arange(T)[:, None]
                             + T * np.arange(-(-(hi - lo) // T))[None, :])
                put(p, offs[offs < hi].ravel())
            else:
                assert (hi - lo) % 16 == 0 and 0 < hi - lo <= tpg.CHUNK
                v = vectors((hi - lo) // 16)
                put(p, (lo + 16 * v[:, None] + np.arange(16)).ravel())
    assert writes.sum() == puts[0]
    return out, writes


def _pairs(rng, n, Sd, Ss, bad=0.1):
    """``n`` pairs with unique destinations, some -1 and some out of
    range."""
    di = np.full(n, -1, np.int32)
    take = min(n, Sd)
    di[:take] = rng.permutation(Sd)[:take]
    si = rng.integers(0, Ss, n).astype(np.int32)
    for idx, rows in ((di, Sd), (si, Ss)):
        mark = rng.random(n)
        idx[mark < bad / 2] = -1
        idx[(mark >= bad / 2) & (mark < bad)] = rows + 3
    order = rng.permutation(n)
    return di[order], si[order]


def _same(got, want) -> None:
    if not np.array_equal(got, want):
        first = np.argwhere(np.asarray(got) != np.asarray(want))[0]
        raise AssertionError(f"first difference at {first.tolist()}")


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _jax_rows(Sd: int, Ss: int, di, si) -> np.ndarray:
    """The source row that ``repro.kernels.ref.page_copy_ref`` puts in each
    of ``Sd`` destination rows (-1: none), on row ids as one-element
    payloads; rows and pairs are padded (-1 pairs) to shared shapes, so
    that every case runs one compiled loop."""
    rows, n = max(512, _pow2(max(Sd, Ss))), max(512, _pow2(len(di)))
    pairs = [jnp.asarray(np.pad(x, (0, n - len(x)), constant_values=-1))
             for x in (di, si)]
    out = _JREF(jnp.full((rows, 1), -1, jnp.int32),
                             jnp.arange(rows, dtype=jnp.int32)[:, None],
                             *pairs)
    return np.asarray(out)[:Sd, 0]


def check(pools: Pools, di, si, sms=H100_SMS):
    plan = tpg.copy_plan(len(di), pools.R, pools.align(), sms)
    got, writes = emulate(plan, pools, di, si)
    # The kernel skips out-of-range pairs: the references see them as -1.
    live = ((di >= 0) & (di < pools.Sd) & (si >= 0) & (si < pools.Ss))
    ldi, lsi = np.where(live, di, -1), np.where(live, si, -1)
    want = pools.dst.copy()
    tref.page_copy_ref(pools.view(want, pools.d_off, pools.d_stride,
                                  pools.Sd),
                       pools.view(pools.src, pools.s_off, pools.s_stride,
                                  pools.Ss),
                       torch.as_tensor(ldi), torch.as_tensor(lsi))
    _same(got, want)
    expect = np.zeros(len(want), np.int64)
    for d in ldi[ldi >= 0]:
        start = pools.d_off + int(d) * pools.d_stride
        expect[start:start + pools.R] = 1
    _same(writes, expect)
    got_rows = pools.rows_of(got, pools.d_off, pools.d_stride, pools.Sd)
    before = pools.rows_of(pools.dst, pools.d_off, pools.d_stride, pools.Sd)
    src_rows = pools.rows_of(pools.src, pools.s_off, pools.s_stride,
                             pools.Ss)
    m = _jax_rows(pools.Sd, pools.Ss, ldi, lsi)
    _same(got_rows, np.where((m >= 0)[:, None], src_rows[np.maximum(m, 0)],
                             before))
    return plan


# The main paths' row bytes (one layer's page: the prefill population of
# tier 2; an int8 slot's scale row) and N, cut, into layer 1 of 3.
MAIN = {"whisper": (192 * 1024, 4), "paligemma": (128 * 1024, 4),
        "mistral/mixtral": (512 * 1024, 2),
        "recurrentgemma": (128 * 1024, 4),
        "int8 pages": (256 * 1024, 3), "int8 scales": (1024, 40)}


@pytest.mark.parametrize("name", sorted(MAIN))
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_main_path_shapes(name, sms):
    R, n = MAIN[name]
    rng = np.random.default_rng(len(name))
    Sd = n + 2
    pools = Pools(rng, R, Sd, n, R, 3 * R, 0, R)
    di, si = _pairs(rng, n, Sd, n, bad=0.3)
    plan = check(pools, di, si, sms=sms)
    assert plan.path == "vector"


@pytest.mark.parametrize("n,R,d_off,sms", [
    (0, 4096, 0, 132), (1, 64, 0, 132), (1, 16, 0, 1), (3, 7, 0, 2),
    (5, 20_003, 1, 3), (2, 17 * 1024, 0, 132), (4, 4096 + 16, 0, 1),
    (3, 16_400, 0, 132), (2, 3 * 16_384 + 16, 16, 5),  # chunks rounded up
    (8, 65_536, 0, 1),  # 32 items on 8 blocks, 4 a block
    (10_000, 16, 0, 132), (300, 48, 8, 132),
])
@pytest.mark.parametrize("s_gap", [0, 16])
def test_edge_cases(n, R, d_off, sms, s_gap):
    """``s_gap``: source rows packed, or strided 16 bytes apart."""
    rng = np.random.default_rng(n + R)
    Sd = n + 2
    gap = 16 if R % 2 == 0 else 0  # rows of even size not packed
    pools = Pools(rng, R, Sd, max(n, 1), d_off, R + gap, 0, R + s_gap)
    di, si = _pairs(rng, n, Sd, max(n, 1))
    check(pools, di, si, sms=sms)


ROW_SIZES = st.one_of(
    st.sampled_from([1, 15, 16, 1024, 4095, 4096, 4112, 16384, 16400,
                     196608, 2**20]),
    st.integers(1, 2**20))


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(R=ROW_SIZES, data=st.data())
def test_drawn_cases(R, data):
    n = data.draw(st.integers(0, min(300, max(1, 2**21 // R))), label="n")
    layers = data.draw(st.integers(1, 3), label="layers")
    li = data.draw(st.integers(0, layers - 1), label="layer")
    base = data.draw(st.sampled_from([0, 0, 16, 1, 8]), label="base")
    s_base = data.draw(st.sampled_from([0, 0, 16, 3]), label="src base")
    s_gap = data.draw(st.sampled_from([0, 0, 16, 5]), label="src gap")
    sms = data.draw(st.sampled_from([1, 7, 132]), label="sms")
    seed = data.draw(st.integers(0, 2**31), label="seed")
    rng = np.random.default_rng(seed)
    Ss = max(n, 1)
    Sd = Ss + data.draw(st.integers(0, 4), label="spare")
    pools = Pools(rng, R, Sd, Ss, base + li * R, layers * R, s_base,
                  R + s_gap)
    di, si = _pairs(rng, n, Sd, Ss, bad=0.2)
    check(pools, di, si, sms=sms)


def test_plan_fills_the_card():
    """Whisper's population (32 rows of 192 KiB, the smallest on the main
    paths) gives every SM of an H100 at least two items; chunks are cut
    evenly from the row and never exceed a block's loads."""
    plan = tpg.copy_plan(32, 192 * 1024, 0, H100_SMS)
    assert plan.path == "vector" and plan.chunk <= tpg.CHUNK
    assert 32 * plan.chunks >= 2 * H100_SMS
    assert plan.blocks == min(32 * plan.chunks,
                              tpg.BLOCKS_PER_SM * H100_SMS)
    odd = tpg.copy_plan(1, 17 * 1024, 0, H100_SMS)
    assert (odd.chunk, odd.chunks) == (8704, 2)
    assert tpg.copy_plan(8, 1024, 4, H100_SMS).path == "bytes"


def test_cpu_wrapper_unchanged():
    """On CPU tensors the wrapper is the plain version: equal results, no
    launch, and an index out of range raises."""
    rng = np.random.default_rng(3)
    dst = torch.as_tensor(rng.normal(size=(6, 3, 5)), dtype=torch.float32)
    src = torch.as_tensor(rng.normal(size=(4, 3, 5)), dtype=torch.float32)
    di = torch.tensor([5, -1, 0, 2], dtype=torch.int32)
    si = torch.tensor([3, 1, -1, 0], dtype=torch.int32)
    before = tpg.page_copy_launch_count()
    got = tpg.page_copy(dst.clone(), src, di, si)
    assert torch.equal(got, tref.page_copy_ref(dst.clone(), src, di, si))
    assert tpg.page_copy_launch_count() == before
    for bad_d, bad_s in (([6], [0]), ([0], [4]), ([-2], [0])):
        with pytest.raises(IndexError):
            tpg.page_copy(dst.clone(), src, torch.tensor(bad_d),
                          torch.tensor(bad_s))
    assert tpg.card_index("cpu", di, si) == (di, si)
