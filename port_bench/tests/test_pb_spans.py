"""The readers of the program's own spans and counters
(``repro_torch.obs``): ``alloc_ms.decode``, ``launch_idle_ms.decode`` and
``moe_fill.prefill``, on hand-built records with known sums, on CPU
records (no device trace) and a dense model (no experts), on a tiny MoE
cell traced on the CPU, and, on the card, the program's spans kept off
the device timeline."""
from __future__ import annotations

import collections
import contextlib
import time

import pytest

from port_bench import harness, trace

from pb_tiny import ROOT

PROGRAM_SPANS = {"engine.prefill", "engine.decode_step", "kv.alloc",
                 "model.layers"}


def _read(name: str, rec: dict):
    return harness.reader(ROOT, name)(rec)


def _rec(device=True, experts=0) -> dict:
    """Two profiled decode steps over [0, 1000] ns: the device busy over
    [100, 150] and [300, 400]; ``kv.alloc`` 30 + 20 ns; ``model.layers``
    over [50, 250] and [240, 500], which overlap."""
    dec = dict(
        device=[("k0", 100, 50), ("k1", 300, 100)] if device else [],
        host=[("engine.decode_step", 0, 520), ("kv.alloc", 10, 30),
              ("model.layers", 50, 200), ("aten::mm", 60, 5),
              ("engine.decode_step", 230, 700), ("kv.alloc", 210, 20),
              ("model.layers", 240, 260)],
        lo=0, hi=1000, steps=2,
        busy=[[100, 150], [300, 400]] if device else [])
    dec["kernels"] = list(dec["device"])
    return dict(profile=dict(decode=dec, prefill=dict(device=[], host=[])),
                model=dict(experts=experts))


def test_alloc_ms_sums_the_alloc_spans_a_step():
    assert _read("alloc_ms.decode", _rec()) == pytest.approx(50 / 1e6 / 2)


def test_launch_idle_ms_is_the_layer_loop_less_the_busy_device():
    # The loop's union [50, 500] (450 ns) less the busy 50 + 100 ns.
    assert _read("launch_idle_ms.decode", _rec()) == \
        pytest.approx(300 / 1e6 / 2)


def test_moe_fill_reads_the_prefills_counters(monkeypatch):
    from repro_torch import obs
    monkeypatch.setattr(obs, "snapshot", lambda: {
        "engine.prefill": {"moe.kept": 78, "moe.slots": 100},
        "engine.decode_step": {"moe.kept": 1, "moe.slots": 100}})
    assert _read("moe_fill.prefill", _rec(experts=8)) == pytest.approx(78)
    assert _read("moe_fill.prefill", _rec(experts=0)) is None
    monkeypatch.setattr(obs, "snapshot", lambda: {})
    assert _read("moe_fill.prefill", _rec(experts=8)) is None


@pytest.mark.parametrize("name", ["alloc_ms.decode",
                                  "launch_idle_ms.decode"])
def test_span_readers_are_none_off_the_card_or_without_spans(name):
    assert _read(name, _rec(device=False)) is None
    rec = _rec()
    rec["profile"]["decode"]["host"] = [("aten::mm", 60, 5)]
    assert _read(name, rec) is None


def test_tiny_moe_cell_reads_the_programs_counters(tiny_root):
    from repro_torch import obs
    obs.reset()
    cell = harness.load_cell(tiny_root, "tiny-moe")
    out = harness.run(tiny_root, cell, 2**31 + 5, 0.2, True, "cpu",
                      time.perf_counter())
    counts = obs.snapshot()["engine.prefill"]
    fill = out["metrics"]["moe_fill.prefill"]
    assert fill == dict(value=100 * counts["moe.kept"] / counts["moe.slots"],
                        unit="%")
    assert 0 < fill["value"] <= 100
    # The CPU has no device trace: the span readers report nothing.
    assert "alloc_ms.decode" not in out["metrics"]
    assert "launch_idle_ms.decode" not in out["metrics"]
    obs.reset()


@pytest.mark.cuda
def test_program_spans_stay_off_the_device_timeline(tiny_root, card,
                                                    monkeypatch):
    """The tiny dense cell traced on the card: no device event bears a
    program span's name, and the launches and device events are the same
    with the spans live as with ``obs.span`` the null context."""
    from repro_torch import obs
    cell = harness.load_cell(tiny_root, "tiny-dense")
    params = harness.make_weights(cell["config_data"], 11, "cuda")
    server = harness.Server(cell, "cuda")
    collections.deque(server.round(params, server.prompts(11, 0), steps=5),
                      maxlen=0)

    def profiled():
        prof = trace.profile(server, params, 11, 4, 4, True)
        names = {ph: collections.Counter(
            n for n, _, _ in prof[ph]["device"])
            for ph in ("prefill", "decode")}
        return prof, names

    # A process's first profile on the card can hold a stray kernel (one
    # gather in a prefill, seen with the spans live after the CPU tests of
    # this file, never in a fresh process): it is taken and set aside.
    profiled()
    live, live_names = profiled()
    hosts = {n for n, _, _ in live["decode"]["host"]}
    assert {"engine.decode_step", "kv.alloc", "model.layers"} <= hosts
    for ph in ("prefill", "decode"):
        assert live[ph]["kernels"]
        assert not PROGRAM_SPANS & set(live_names[ph])
    monkeypatch.setattr(obs, "span", lambda name: contextlib.nullcontext())
    null, null_names = profiled()
    assert not PROGRAM_SPANS & {n for n, _, _ in null["decode"]["host"]}
    for ph in ("prefill", "decode"):
        assert live_names[ph] == null_names[ph], (
            ph, "live only:", live_names[ph] - null_names[ph],
            "null only:", null_names[ph] - live_names[ph])
    rec = lambda prof: dict(profile=prof)  # noqa: E731
    assert _read("launches_per_step.decode", rec(live)) == \
        _read("launches_per_step.decode", rec(null))
