"""``repro_torch.obs``: spans and counters inside the serving path, live
only while ``torch.profiler`` runs (CPU).

- Untraced, a span enters no record (the recording primitive patched to
  raise) and a counter counts nothing.
- Under ``torch.profiler``, a reduced mistral-nemo's decode steps each
  hold one ``kv.alloc`` followed by one ``model.layers``, inside the
  step's ``engine.decode_step``; the prefill is one ``engine.prefill``.
- Tokens, logprobs and the whole pool state are bit for bit the same
  traced and untraced.
- A reduced mixtral's ``moe.kept`` and ``moe.slots`` equal counts made
  here from the router's top-k (``sum_e min(load_e, C)`` and ``E C``) and
  agree with ``MoEOut.dropped``; a served step files them under its root.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs.archs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.params import init_params
from repro_torch.serving.engine import (ServeConfig, make_decode_step,
                                        make_prefill_step)

B, S, STEPS = 4, 30, 6   # the decode steps cross a page edge at 32


def _serve_fns(arch: str):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    sc = ServeConfig(max_seq=64, batch_local=B, hbm_fraction=0.5,
                     n_promote=2)
    return (cfg, init_params(cfg, 0, "cpu"), make_prefill_step(cfg, sc),
            make_decode_step(cfg, sc))


@pytest.fixture(scope="module")
def nemo():
    return _serve_fns("mistral-nemo-12b")


def _run(fns, steps=STEPS):
    cfg, params, prefill, decode = fns
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)
    state, (tok, lp) = prefill(params, prompts)
    toks, lps = [tok], [lp]
    for _ in range(steps):
        state, (tok, lp) = decode(params, state, tok)
        toks.append(tok)
        lps.append(lp)
    return torch.stack(toks, 1), torch.stack(lps, 1), state


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    return [torch.as_tensor(x)]


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def test_untraced_span_records_nothing_and_add_counts_nothing(
        nemo, monkeypatch):
    def refuse(*_):
        raise AssertionError("a span recorded with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    obs.reset()
    assert obs.span("engine.prefill") is obs.span("kv.alloc")
    _run(nemo, steps=2)
    obs.add("moe.kept", torch.ones(4, dtype=torch.bool))
    obs.add("moe.slots", 8)
    assert obs.snapshot() == {}


def test_decode_steps_hold_alloc_then_layers(nemo):
    _, events = _profiled(lambda: _run(nemo))

    def named(n):
        return [(s, e) for name, s, e in events if name == n]

    steps, allocs, loops = (named("engine.decode_step"), named("kv.alloc"),
                            named("model.layers"))
    assert len(named("engine.prefill")) == 1
    assert len(steps) == len(allocs) == len(loops) == STEPS
    for lo, hi in steps:
        a = [iv for iv in allocs if lo <= iv[0] and iv[1] <= hi]
        m = [iv for iv in loops if lo <= iv[0] and iv[1] <= hi]
        assert len(a) == len(m) == 1
        assert a[0][1] <= m[0][0]
    (_, phi), = named("engine.prefill")
    assert all(phi <= lo for lo, _ in steps)


def test_profiler_changes_no_token_and_no_pool(nemo):
    plain = _run(nemo)
    traced, _ = _profiled(lambda: _run(nemo))
    a, b = _leaves(plain), _leaves(traced)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _moe_inputs(cfg, T, seed):
    g = torch.Generator().manual_seed(seed)
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff

    def draw(*shape):
        return torch.randn(*shape, generator=g) * 0.5

    # A shared offset in x skews the routing, so that some expert
    # overflows its capacity and slots drop.
    return draw(T, d) + 0.3, draw(d, E), draw(E, d, f), draw(E, d, f), \
        draw(E, f, d)


@pytest.mark.parametrize("T", [24, 96, 200])
def test_moe_counters_match_the_routing(T):
    cfg = get_config("mixtral-8x22b").reduced()
    mc = cfg.moe
    E, K, C = mc.n_experts, mc.top_k, tmoe.capacity(T, mc)
    x, wr, wg, wu, wd = _moe_inputs(cfg, T, T)
    _, _, top_e = tmoe.route(x, wr, mc)
    load = torch.bincount(top_e.reshape(-1), minlength=E)
    kept = int(torch.clamp(load, max=C).sum())
    assert kept < T * K   # slots are dropped
    obs.reset()

    def call():
        with obs.span("engine.prefill"):
            return tmoe.moe_swiglu(x, wr, wg, wu, wd, mc)

    out, _ = _profiled(call)
    counts = obs.snapshot()
    assert counts == {"engine.prefill": {"moe.kept": kept,
                                         "moe.slots": E * C}}
    assert abs(float(out.dropped) - (1 - kept / (T * K))) < 1e-6
    obs.reset()


def test_moe_counters_are_filed_under_their_step():
    fns = _serve_fns("mixtral-8x22b")
    cfg = fns[0]
    obs.reset()
    _profiled(lambda: _run(fns, steps=2))
    counts = obs.snapshot()
    E = cfg.moe.n_experts
    assert set(counts) == {"engine.prefill", "engine.decode_step"}
    assert counts["engine.prefill"]["moe.slots"] == \
        cfg.n_layers * E * tmoe.capacity(B * S, cfg.moe)
    assert counts["engine.decode_step"]["moe.slots"] == \
        2 * cfg.n_layers * E * tmoe.capacity(B, cfg.moe)
    for c in counts.values():
        assert 0 < c["moe.kept"] <= c["moe.slots"]
    obs.reset()
