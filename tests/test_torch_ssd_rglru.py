"""The SSD and RG-LRU scans and blocks on the CPU against the reference.

- the plain ``ssd_scan`` (chunk by chunk, as ``csrc/ssd_scan.cu``) and
  ``ref.ssd_ref`` against ``repro.kernels.ops.ssd_scan(interpret=True)``
  and ``repro.kernels.ref.ssd_ref`` at the shapes of
  ``tests/test_kernels.py``, plus a ragged ``S % Q != 0`` case: relative
  1e-5 (the reference test's bar; f32 products summed in another order);
- the final state against ``ssd_chunked(return_state=True)``: relative
  1e-5;
- the plain ``rglru_scan`` and ``ref.rglru_ref`` against
  ``ops.rglru_scan(interpret=True)`` and ``repro.kernels.ref.rglru_ref``:
  1e-5 absolute (the reference test's bar);
- ``ssd_block`` and ``recurrent_block`` with ``capture=True`` (their
  decode states included) and their ``*_step`` forms against
  ``repro.models.ssd`` and ``repro.models.rglru`` in f32: 1e-5 (the
  reference's associative scans against the port's sequential and
  chunked ones); in bf16 the RG-LRU handoff state is the bf16 output cast
  back to f32, exactly as the reference's;
- the paged kernel's sliding window against the reference's
  ``read_pages`` + ``attention_partial``: 3e-5;
- ROADMAP faults item (h): with fewer pages than the read window, the
  reference's ``read_pages`` clips the window's page indices to the last
  page and counts that page's tokens more than once; the port reads each
  page once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.distributed.axes import SINGLE
from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro.models import params as jpm
from repro.models import rglru as jrg
from repro.models import ssd as jssd
from repro.serving import engine as jeng
from repro.serving import kvpool as jkvp
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trs
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import rglru as trg
from repro_torch.models import ssd as tssd
from repro_torch.models.attention import Partial, combine_partials
from repro_torch.models.layers import causal_conv1d
from repro_torch.serving import engine as teng
from repro_torch.serving import kvpool as tkvp


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _ssd_inputs(rng, B, S, H, P, N):
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.5 + 0.01).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,S,H,P,N,Q", [(2, 64, 3, 8, 16, 16),
                                         (1, 128, 2, 16, 8, 32),
                                         (2, 45, 3, 8, 16, 16)])  # ragged
def test_ssd_scan_plain(B, S, H, P, N, Q, rng):
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, S, H, P, N)
    want = np.asarray(ref.ssd_ref(*(jnp.asarray(a) for a in
                                    (x, dt, A, Bm, Cm))))
    got, h = tss.ssd_scan(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk=Q)
    assert got.shape == x.shape and h.shape == (B, H, N, P)
    assert tss.ssd_scan_launch_count() == 0
    assert _rel(got.numpy(), want) < 1e-5
    assert _rel(tref.ssd_ref(*(_t(a) for a in (x, dt, A, Bm, Cm))).numpy(),
                want) < 1e-5
    if S % Q == 0:  # the Pallas kernel asserts whole chunks
        pallas = np.asarray(ops.ssd_scan(
            *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=Q,
            interpret=True))
        assert _rel(got.numpy(), pallas) < 1e-5
    # The final state that ``ssd_chunked`` hands to decode.
    _, jh = jssd.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                             Q, return_state=True)
    assert _rel(h.numpy(), jh) < 1e-5


def test_ssd_scan_plain_decay_never_overflows(rng):
    """A chunk whose cumulative decay spans more than f32's exponent range:
    above the diagonal ``exp(cum_t - cum_s)`` overflows to inf, which a 0/1
    mask would turn into NaN; the plain version selects instead."""
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 32, 2, 8, 8)
    dt[:] = 20.0
    A[:] = -10.0   # cum falls by 200 a step
    y, h = tss.ssd_scan(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want = np.asarray(ref.ssd_ref(*(jnp.asarray(a) for a in
                                    (x, dt, A, Bm, Cm))))
    assert _rel(y.numpy(), want) < 1e-5


@pytest.mark.parametrize("B,S,W,bw,ch", [(2, 64, 32, 16, 16),
                                         (1, 128, 64, 64, 32)])
def test_rglru_scan_plain(B, S, W, bw, ch, rng):
    u = rng.normal(size=(B, S, W)).astype(np.float32)
    ps = [(rng.normal(size=(W,)) * 0.5).astype(np.float32) for _ in range(5)]
    pallas = np.asarray(ops.rglru_scan(jnp.asarray(u),
                                       *(jnp.asarray(p) for p in ps),
                                       block_w=bw, chunk=ch, interpret=True))
    want = np.asarray(ref.rglru_ref(jnp.asarray(u),
                                    *(jnp.asarray(p) for p in ps)))
    got = trs.rglru_scan(_t(u), *(_t(p) for p in ps))
    assert got.dtype == torch.float32 and trs.rglru_scan_launch_count() == 0
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tref.rglru_ref(_t(u), *(_t(p) for p in ps))
                               .numpy(), want, atol=1e-5, rtol=0)


def _layer_params(name, dtype="float32", pos=0):
    """Layer 0 of pattern position ``pos`` of the reduced config, from the
    reference's initializer: (cfg, reference params, port params)."""
    cfg = dataclasses.replace(J_ARCHS[name].reduced(), param_dtype=dtype)
    jp = jpm.init_params(cfg, jax.random.PRNGKey(2))
    jl = jax.tree.map(lambda w: w[0], jp["blocks"][pos])
    tl = params_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")
    return cfg, jl, tl


def _close(got, want, tol, ctx):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=ctx)


def test_ssd_block_and_step_match_reference(rng):
    cfg, jl, tl = _layer_params("mamba2-370m")
    s = cfg.ssm
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    jout, jst = jssd.ssd_block(jnp.asarray(x), jl, s, SINGLE, capture=True)
    tout, tst = tssd.ssd_block(_t(x), tl, T_ARCHS["mamba2-370m"].reduced()
                               .ssm, capture=True)
    _close(tout, jout, 1e-5, "ssd_block out")
    assert sorted(tst) == sorted(jst)
    for k in jst:
        _close(tst[k], jst[k], 1e-5, f"ssd_block state {k}")
    for t in range(4):
        xt = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
        jout, jst = jssd.ssd_block_step(jnp.asarray(xt), jst, jl, s, SINGLE)
        tout, tst = tssd.ssd_block_step(_t(xt), tst, tl, s)
        _close(tout, jout, 1e-5, f"ssd_block_step {t} out")
        for k in jst:
            _close(tst[k], jst[k], 1e-5, f"ssd_block_step {t} state {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_block_and_step_match_reference(dtype, rng):
    """f32 within 1e-5; bf16 within one bf16 step of the outputs (2e-2:
    the reference's associative scan and the port's sequential one round
    different f32 values), and the handoff state, by construction the
    bf16 output cast back to f32, equal to the port's own bf16 output."""
    _, jl, tl = _layer_params("recurrentgemma-9b", dtype)
    d = tl["w1"].shape[0]
    x = (rng.normal(size=(2, 29, d)) * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = _t(x).to(getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    jout, jst = jrg.recurrent_block(jx, jl, SINGLE, capture=True)
    tout, tst = trg.recurrent_block(tx, tl, capture=True)
    assert tout.dtype == tx.dtype and tst["h"].dtype == torch.float32
    _close(tout, jout, tol, "recurrent_block out")
    for k in jst:
        _close(tst[k], jst[k], tol, f"recurrent_block state {k}")
    u = causal_conv1d(torch.matmul(tx, tl["w2"]), tl["conv"])
    h = trs.rglru_scan(u, *(tl[k] for k in ("w_a", "b_a", "w_x", "b_x",
                                            "lam")))
    assert torch.equal(tst["h"], h[:, -1].float())
    for t in range(4):
        xt = (rng.normal(size=(2, d)) * 0.5).astype(np.float32)
        jout, jst = jrg.recurrent_block_step(
            jnp.asarray(xt, jnp.dtype(dtype)), jst, jl, SINGLE)
        tout, tst = trg.recurrent_block_step(
            _t(xt).to(getattr(torch, dtype)), tst, tl)
        _close(tout, jout, tol, f"recurrent_block_step {t} out")
        for k in jst:
            _close(tst[k], jst[k], tol, f"recurrent_block_step {t} state {k}")


def _window_states(rng, max_seq, length):
    """Both engines' pools for reduced recurrentgemma (window 32, page 16,
    read window 3 pages) after a prefill of ``length`` tokens, with the
    same random pool contents."""
    jcfg, tcfg = (dataclasses.replace(A["recurrentgemma-9b"].reduced(),
                                      param_dtype="float32")
                  for A in (J_ARCHS, T_ARCHS))
    jsc = jeng.ServeConfig(max_seq=max_seq, batch_local=2, page_axes=(),
                           hbm_fraction=0.5)
    tsc = teng.ServeConfig(max_seq=max_seq, batch_local=2, hbm_fraction=0.5)
    jspec = jeng.make_kv_spec(jcfg, jsc, 1)
    tspec = teng.make_kv_spec(tcfg, tsc)
    assert (tspec.read_pages, tspec.window) == (3, 32)
    jkv = jkvp.prefill_residency(
        jkvp.init_paged_kv(jspec, jnp.zeros((), jnp.int32)), jspec,
        jnp.full((2,), length, jnp.int32))
    tkv = tkvp.prefill_residency(tkvp.init_paged_kv(tspec, device="cpu"),
                                 tspec, torch.full((2,), length))
    p1 = rng.normal(size=jkv.pool1.shape).astype(np.float32)
    p2 = rng.normal(size=jkv.pool2.shape).astype(np.float32)
    jkv = jkv._replace(pool1=jnp.asarray(p1), pool2=jnp.asarray(p2))
    tkv = tkv._replace(pool1=_t(p1), pool2=_t(p2))
    q = rng.normal(size=(2, tcfg.n_heads, tcfg.head_dim)).astype(np.float32)
    return jspec, tspec, jkv, tkv, q


def _port_two_tier(tkv, tspec, q):
    slot1, slot2, live = teng._decode_tables(tkv, tspec, "cpu")
    parts = [Partial(*tpa.paged_attention(_t(q), pool[:, 0], slot, live,
                                          tspec.window))
             for pool, slot in ((tkv.pool1, slot1), (tkv.pool2, slot2))]
    return combine_partials(parts).numpy()


@pytest.mark.parametrize("length", [40, 47, 61])
def test_windowed_two_tier_read_matches_reference(length, rng):
    """The decode step's windowed read (tables cut to the read window, the
    kernel's token mask at ``lengths + 1 - window``) against the
    reference's ``read_pages`` + ``attention_partial``, within 3e-5; the
    port's plain ``read_pages`` gives the reference's K/V and mask."""
    jspec, tspec, jkv, tkv, q = _window_states(rng, 64, length)
    k, v, valid = jkvp.read_pages((jkv.pool1, jkv.pool2), jkv, jspec, 0)
    assert int(valid.sum()) == 2 * 32     # exactly the window is live
    part = jattn.attention_partial(jnp.asarray(q), k, v, valid)
    want = np.asarray(part.acc / part.l[..., None]).reshape(q.shape)
    np.testing.assert_allclose(_port_two_tier(tkv, tspec, q), want,
                               atol=3e-5, rtol=3e-5)
    tk, tv, tvalid = tkvp.read_pages((tkv.pool1, tkv.pool2), tkv, tspec, 0)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))


def test_reference_read_window_past_the_last_page_double_counts(rng):
    """ROADMAP faults item (h). With 2 pages a sequence and a 3-page read
    window, the reference reads pages 0, 1, 1: the current page's 5 live
    tokens (16..20) count twice, 26 positions for 21 tokens, and its
    attention differs from attention over the 21 tokens. The port reads
    each page once and agrees with that attention."""
    jspec, tspec, jkv, tkv, q = _window_states(rng, 32, 20)
    assert jspec.n_pages == 2 < jspec.read_pages
    k, v, valid = jkvp.read_pages((jkv.pool1, jkv.pool2), jkv, jspec, 0)
    assert int(valid.sum()) == 2 * 26
    part = jattn.attention_partial(jnp.asarray(q), k, v, valid)
    ref_o = np.asarray(part.acc / part.l[..., None]).reshape(q.shape)
    _, _, tvalid = tkvp.read_pages((tkv.pool1, tkv.pool2), tkv, tspec, 0)
    assert int(tvalid.sum()) == 2 * 21
    # Attention over each of the 21 tokens once, from the reference's own
    # gather with the repeated page masked out.
    once = np.asarray(valid).copy()
    once[:, 2 * 16:] = False
    part1 = jattn.attention_partial(jnp.asarray(q), k, v, jnp.asarray(once))
    want = np.asarray(part1.acc / part1.l[..., None]).reshape(q.shape)
    got = _port_two_tier(tkv, tspec, q)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
    assert np.abs(ref_o - want).max() > 1e-2
