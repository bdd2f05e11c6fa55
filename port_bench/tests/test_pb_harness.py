"""The harness: cells, configurations and metrics found by name, the result
line's keys, ``BENCHMARK.json``'s names and units, and the refusal to run
without a card."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import pytest

from port_bench import harness

from pb_tiny import ROOT, add_cell, tiny_config, write

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_lines_are_the_contracts():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in b[group]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            for key in ("config", "traffic"):
                if key in entry:
                    assert NAME.match(entry[key])
            assert all(NAME.match(k) for k in entry.get("reduced", []))
    assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_entry_has_its_file():
    b = bench()
    for c in b["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == c["reduced"]
    for w in b["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(ROOT, m["name"]))
    ends = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in ends
    assert all(m["moves"] in ends for m in b["per_layer"])


def test_every_cell_reports_what_its_metrics_move():
    """Each cell reports ``setup_s``, another end-to-end metric and a
    per-layer one, and every end-to-end metric that a per-layer metric of
    the cell moves."""
    b = bench()
    for w in b["workloads"]:
        def of(group):
            return {m["name"]: m for m in b[group]
                    if w["name"] in m.get("workloads", [w["name"]])}
        ends, layers = of("end_to_end"), of("per_layer")
        assert "setup_s" in ends and len(ends) >= 2 and layers, w["name"]
        assert all(m["moves"] in ends for m in layers.values()), w["name"]


@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line_has_the_contracts_keys(tiny_root, trace_on):
    cell = harness.load_cell(tiny_root, "tiny-dense")
    # Long enough for decode steps inside the window on a loaded CPU.
    out = harness.run(tiny_root, cell, 2**31 + 9, 2.0, trace_on, "cpu",
                      time.perf_counter())
    assert KEYS <= set(out) <= KEYS | {"breakdown", "check"}
    assert list(out)[-1] == "check"
    assert ("breakdown" in out) == trace_on
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % 4 == 0 and out["attempted"] >= 4
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace_on:
        assert set(out["metrics"]) == {"tok_s", "itl_p95_ms",
                                       "prefill_tok_s", "setup_s"}
    else:
        # The CPU has no device trace: only what is not read from one.
        assert set(out["metrics"]) == {"t1_hit_share", "mfu.decode",
                                       "mbu.decode", "mfu.prefill",
                                       "tok_s.host_bound",
                                       "itl_p95_ms.host_bound"}
    json.dumps(out)


def test_new_cell_config_and_metric_are_picked_up(tiny_root):
    """A cell, its configuration, its traffic and a per-layer metric, each
    added as a new file (and an entry of ``BENCHMARK.json``), run with no
    file of the benchmark edited."""
    pb = tiny_root / "port_bench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    write(pb / "traffic" / "tiny-long.json",
          dict(json.loads((pb / "traffic" / "tiny.json").read_text()),
               prompt_tokens=48))
    add_cell(tiny_root, "tiny-new", tiny_config("tiny-new-config",
                                                "mistral-nemo-12b",
                                                num_hidden_layers=3),
             traffic="tiny-long")
    (pb / "metrics" / "prompt_tokens_seen.py").write_text(
        "def read(rec):\n    return rec['prefill_tokens']\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["per_layer"].append(dict(
        name="prompt_tokens_seen", unit="tokens", better="higher",
        source="program_counter", layer="engine", moves="tok_s",
        workloads=["tiny-new"]))
    write(tiny_root / "BENCHMARK.json", b)
    assert all(p.read_bytes() == data for p, data in before.items())

    cell = harness.load_cell(tiny_root, "tiny-new")
    out = harness.run(tiny_root, cell, 3, 2.0, True, "cpu",
                      time.perf_counter())
    assert out["correct"] is True
    assert out["metrics"]["prompt_tokens_seen"]["value"] % (4 * 48) == 0


def test_run_fails_without_a_card():
    """No card here: the run exits with another code than 0 and prints no
    result, rather than falling back to the CPU."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "port_bench" / "run.py"), "--workload",
         "nemo-3k-2tier", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and the benchmark's own
    files runs nothing."""
    import shutil
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "nemo-3k-2tier",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_jax_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in harness.jax_modules()
    monkeypatch.setitem(sys.modules, "repro.sim", sys)
    assert harness.jax_modules() == ["repro"]


@pytest.mark.cuda
def test_one_cell_on_the_card(tiny_root, card):
    """The tiny dense cell through ``run.py`` on the card: correct, and the
    device named as the contract asks."""
    import shutil
    shutil.copytree(ROOT / "src", tiny_root / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "tiny-dense",
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=tiny_root, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert "paged_roofline.decode" in out["metrics"]
