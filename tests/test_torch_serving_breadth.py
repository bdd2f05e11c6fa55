"""The port's serving breadth on the CPU against the JAX package: whisper-tiny
(encoder-decoder), paligemma-3b (VLM prefix) and mixtral-8x22b (MoE).

Reduced configurations in f32, the reference's parameters carried over by
``params_from_numpy``, inputs from numpy seeds:

- prefill + 12 teacher-forced decode steps with tier 1 at 0.6 of the
  pages (the shape of ``tests/test_serving.py``, with evictions): tokens
  equal, logprobs
  within 1e-5, every integer of the tier state equal and the learner's
  weights bit for bit after every step, whisper's cross-attention keys
  and values within 1e-6 of their largest magnitude; MoE at capacity
  factor E / K, as the reference's test runs it;
- ``fwd_hidden`` with ``frames`` / ``prefix_embeds`` within 1e-5;
- ``moe_swiglu`` at the default capacity factor with slots dropped, the
  dropped fraction exactly the reference's, and the tie order of
  ``jax.lax.top_k``;
- ``blockwise_attention`` and ``attention_ref`` with a prefix and
  non-causal with ``Sq != Skv``, on the shapes of
  ``tests/test_attention.py``;
- ``sinusoidal_positions`` and ``mlp_gelu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.distributed.axes import SINGLE
from repro.kernels.ref import attention_ref as j_attention_ref
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import params as jpm
from repro.models.attention import blockwise_attention as j_blockwise
from repro.models.transformer import fwd_hidden as j_fwd_hidden
from repro.serving import engine as jeng
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.transformer import fwd_hidden
from repro_torch.serving import engine as teng
from test_torch_serving import _assert_state

ARCHS = ["whisper-tiny", "paligemma-3b", "mixtral-8x22b"]


def _cfgs(name):
    """The reduced configuration in f32, MoE at capacity factor E / K (no
    slot dropped), for the reference and the port."""
    out = []
    for A in (J_ARCHS, T_ARCHS):
        c = A[name].reduced()
        moe = None if c.moe is None else dataclasses.replace(
            c.moe, capacity_factor=c.moe.n_experts / c.moe.top_k)
        out.append(dataclasses.replace(c, param_dtype="float32", moe=moe))
    return tuple(out)


def _extras(cfg, rng, B):
    e = {}
    if cfg.enc_dec:
        e["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)) * 0.02
    if cfg.vlm_prefix:
        e["prefix_embeds"] = rng.normal(
            size=(B, cfg.vlm_prefix, cfg.d_model)) * 0.02
    return ({k: jnp.asarray(v, jnp.float32) for k, v in e.items()},
            {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in e.items()})


def _cross_kv_err(jstate, tstate) -> float:
    """The largest |port - reference| of the stored cross-attention keys
    and values over their largest magnitude (0 without any)."""
    err = 0.0
    for jd, td in zip(jstate.rec + jstate.rec_tail,
                      tstate.rec + tstate.rec_tail):
        assert sorted(jd) == sorted(td)
        for k in set(jd) & {"ck", "cv"}:
            want = np.asarray(jd[k], np.float64)
            got = td[k].double().numpy()
            err = max(err, float(np.abs(got - want).max()
                                 / max(np.abs(want).max(), 1e-30)))
    return err


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name, rng):
    """2 sequences, a 32-token prompt (after paligemma's 8 patch
    embeddings; beside whisper's 24 frames), 12 decode steps, tier 1 at
    0.6 of the pages (5 slots), both engines teacher-forced on the same
    tokens. The prompt is twice the reference test's 16 tokens, so that
    each family's 3 pages a sequence outgrow tier 1 and pages are
    evicted and read from tier 2."""
    jcfg, tcfg = _cfgs(name)
    jp = jpm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    B, S0, n_dec = 2, 32, 12
    toks = rng.integers(0, jcfg.vocab, (B, S0 + n_dec)).astype(np.int32)
    jx, tx = _extras(jcfg, rng, B)
    jsc = jeng.ServeConfig(max_seq=64, batch_local=B, page_axes=(),
                           hbm_fraction=0.6)
    tsc = teng.ServeConfig(max_seq=64, batch_local=B, hbm_fraction=0.6)
    spec = teng.make_kv_spec(tcfg, tsc)
    ms = jpm.MeshSizes()
    jpre = jax.jit(jeng.make_prefill_step(jcfg, jsc, SINGLE, ms))
    jdec = jax.jit(jeng.make_decode_step(jcfg, jsc, SINGLE, ms))
    tpre = teng.make_prefill_step(tcfg, tsc)
    tdec = teng.make_decode_step(tcfg, tsc)
    jstate, (jt, jl) = jpre(jp, jnp.asarray(toks[:, :S0]), jx)
    tstate, (tt, tl) = tpre(tp, torch.as_tensor(toks[:, :S0]), tx)
    xerr = 0.0
    for step in range(n_dec + 1):
        ctx = f"{name} step {step}"
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0, err_msg=ctx)
        _assert_state(jstate.kv, tstate.kv, spec, ctx)
        xerr = max(xerr, _cross_kv_err(jstate, tstate))
        if step == n_dec:
            break
        x = toks[:, S0 + step]
        jstate, (jt, jl) = jdec(jp, jstate, jnp.asarray(x))
        tstate, (tt, tl) = tdec(tp, tstate, torch.as_tensor(x))
    assert xerr <= 1e-6, (name, xerr)
    kv = tstate.kv
    assert int(kv.evictions[0]) > 0 and int(kv.t2_reads[0]) > 0, name
    n_pre = jcfg.vlm_prefix
    assert (kv.lengths == n_pre + S0 + n_dec).all()
    if jcfg.enc_dec:
        assert xerr > 0 or all(
            float(d["ck"].abs().max()) > 0 for d in tstate.rec)


@pytest.mark.parametrize("name", ARCHS)
def test_fwd_hidden_matches_reference(name, rng):
    """The port's independent forward, with whisper's frames and
    paligemma's prefix, against the reference's, within 1e-5."""
    jcfg, tcfg = _cfgs(name)
    jp = jpm.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = rng.integers(0, jcfg.vocab, (2, 20)).astype(np.int32)
    jx, tx = _extras(jcfg, rng, 2)
    want, _, _ = j_fwd_hidden(jp, jnp.asarray(toks), jcfg, SINGLE, **jx)
    got, _, _ = fwd_hidden(tp, torch.as_tensor(toks), tcfg, **tx)
    assert got.shape == want.shape == (2, 20 + jcfg.vlm_prefix,
                                       jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _moe_inputs(rng, T=40, d=16, f=24, E=4):
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * s[-2] ** -0.5
         for s in ((d, E), (E, d, f), (E, d, f), (E, f, d))]
    return x, w


def _margins(x, w_router, K):
    """Each token's gap between its K-th and (K+1)-th router probability:
    where a flip of the top-K would come from."""
    p = np.sort(jax.nn.softmax(x @ w_router, -1), -1)[:, ::-1]
    return p[:, K - 1] - p[:, K]


def test_moe_swiglu_drops_the_reference_slots(rng):
    """Capacity factor 1.25 over 40 tokens and 4 experts (C = 32 slots a
    expert for 80 (token, k) slots), routed unevenly so that slots drop:
    the same slots drop, outputs within 1e-5, the load-balance loss within
    1e-6."""
    from repro.configs.base import MoEConfig as JMoE
    from repro_torch.configs.base import MoEConfig as TMoE
    x, w = _moe_inputs(rng)
    x[:, 0] = 3.0 + np.abs(x[:, 0])
    w[0][0, 0] = 2.0  # every token's first choice is expert 0: 8 drop
    jcfg, tcfg = JMoE(n_experts=4, top_k=2), TMoE(n_experts=4, top_k=2)
    want = jmoe.moe_swiglu(jnp.asarray(x), *map(jnp.asarray, w), jcfg, SINGLE)
    got = tmoe.moe_swiglu(torch.as_tensor(x), *map(torch.as_tensor, w), tcfg)
    assert float(want.dropped) > 0
    assert float(got.dropped) == float(want.dropped), (
        got.dropped, want.dropped, _margins(x, w[0], 2))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= 1e-6


def test_moe_top_k_ties_go_to_the_lower_expert(rng):
    """Two experts with equal router columns tie on every token: the port
    picks the same experts, in the same order, as ``jax.lax.top_k``."""
    from repro_torch.configs.base import MoEConfig as TMoE
    x, w = _moe_inputs(rng, T=16)
    w[0][:, 2] = w[0][:, 1]
    w[0][:, 3] = w[0][:, 1] - 0.5  # expert 3 never wins the tie
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x, w[0],
                                      preferred_element_type=jnp.float32))
    _, j_top = jax.lax.top_k(probs, 2)
    _, _, t_top = tmoe.route(torch.as_tensor(x), torch.as_tensor(w[0]),
                             TMoE(n_experts=4, top_k=2))
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    assert (np.asarray(j_top) == [1, 2]).all(axis=1).any()  # a tie won


@pytest.mark.parametrize("S,Skv,H,KV,hd,causal,window,prefix", [
    (64, 64, 4, 2, 16, True, None, 0),
    (100, 100, 4, 1, 8, True, 16, 0),
    (64, 64, 8, 8, 16, False, None, 0),
    (96, 96, 4, 2, 16, True, None, 24),
    (40, 100, 4, 2, 16, False, None, 0),
    (100, 100, 4, 1, 8, True, 16, 40),
])
def test_attention_with_prefix_and_cross(S, Skv, H, KV, hd, causal, window,
                                         prefix, rng):
    """``blockwise_attention`` (blocks of 32 queries and 16 keys) and
    ``attention_ref`` against the reference's ``blockwise_attention``:
    prefix-LM (alone and inside a window), and non-causal with fewer
    queries than keys (whisper's cross-attention)."""
    B = 2
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    want = np.asarray(j_blockwise(*map(jnp.asarray, (q, k, v)), block_q=32,
                                  block_kv=16, **kw))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = blockwise_attention(tq, tk, tv, block_q=32, block_kv=16, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    ref = attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                        tv.transpose(1, 2), **kw).transpose(1, 2)
    np.testing.assert_allclose(ref.numpy(), want, atol=1e-5, rtol=1e-5)
    if not prefix and causal:  # the reference's own plain version
        jref = j_attention_ref(*(jnp.moveaxis(jnp.asarray(a), 2, 1)
                                 for a in (q, k, v)), causal=causal,
                               window=window)
        np.testing.assert_allclose(ref.numpy(),
                                   np.moveaxis(np.asarray(jref), 1, 2),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d", [(24, 64), (448, 384), (1500, 384)])
def test_sinusoidal_positions_match_reference(n, d):
    """Whisper's sinusoids at the reduced and full encoder and decoder
    lengths. XLA's f32 ``exp`` and PyTorch's differ in the last bit for
    about a tenth of the frequencies, so an angle ``position x freq`` may
    round one f32 step apart: the bar is two steps of the angle, 2^-22 x
    the position, and 1e-6 at position 0."""
    pos = np.arange(n)
    want = np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), d))
    got = tlayers.sinusoidal_positions(torch.as_tensor(pos), d).numpy()
    assert got.shape == want.shape == (n, d) and got.dtype == np.float32
    bar = 1e-6 + 2.0 ** -22 * pos[:, None]
    assert (np.abs(got - want) <= bar).all(), np.abs(got - want).max()


def test_mlp_gelu_matches_reference_and_not_exact_gelu(rng):
    """``mlp_gelu`` within 1e-6 of the reference (the tanh approximation,
    ``jax.nn.gelu``'s default); the exact (erf) gelu misses that bar."""
    d, f = 16, 48
    x = rng.normal(size=(3, 5, d)).astype(np.float32)
    # Weights at the models' init scale (fan-in ** -0.5), biases 0.1: the
    # outputs are O(1), where 1e-6 is a few f32 steps.
    ws = [(rng.normal(size=s) * sc).astype(np.float32)
          for s, sc in (((d, f), d ** -0.5), ((f,), 0.1), ((f, d), f ** -0.5),
                        ((d,), 0.1))]
    want = np.asarray(jlayers.mlp_gelu(jnp.asarray(x),
                                       *map(jnp.asarray, ws), SINGLE))
    tx, tws = torch.as_tensor(x), [torch.as_tensor(w) for w in ws]
    got = tlayers.mlp_gelu(tx, *tws).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    h = torch.nn.functional.gelu(tx @ tws[0] + tws[1])
    exact = (h @ tws[2] + tws[3]).numpy()
    assert np.abs(exact - want).max() > 1e-6


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_serves_the_family_on_cpu(name, capsys):
    """``python -m repro_torch.launch.serve --arch <name> --device cpu`` at
    the reduced size: the stub embeddings made, tier reads and the
    learner's weights printed, no kernel launched on the CPU."""
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", name, "--device", "cpu", "--requests", "2",
                 "--prompt", "20", "--new", "6"])
    out = capsys.readouterr().out
    cfg = T_ARCHS[name].reduced()
    assert f"arch={cfg.name} " in out
    assert ("frames=[24, 64]" in out) == cfg.enc_dec
    assert ("prefix_embeds=[8, 64]" in out) == bool(cfg.vlm_prefix)
    assert "tier-1 page reads" in out and "OL weights" in out
    assert "'flash_attention': 0, 'paged_attention': 0" in out
