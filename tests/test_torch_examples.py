"""The port's examples on the CPU: each of the ten runs through its
``main(["--device", "cpu", ...])`` and prints its ``<name> OK`` line.

``stream_replay`` runs at 6,000 requests in chunks of 1,024 (its
``--requests`` / ``--chunk``), since the CPU's plain per-step scan takes
minutes at its default 60,000; the others run at their own sizes.
``train_tiered`` runs in a temporary directory (its shards and
snapshots are relative paths) and once more there to resume from its
snapshot. ``configure_from_model``'s candidates also equal the
reference's ``configure()`` on the same inputs, field for field and in
order.
"""
import dataclasses
import importlib

import numpy as np
import pytest

EXAMPLES = {
    "quickstart": [],
    "end_to_end": [],
    "mrc_curve": [],
    "stream_replay": ["--requests", "6000", "--chunk", "1024"],
    "fault_timeline": [],
    "configure_from_model": [],
    "burst_response": [],
    "warmup_curve": [],
    "serve_paged": [],
}


def _run(name, args, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main(["--device", "cpu", *args])
    text = capsys.readouterr().out
    assert text.rstrip().splitlines()[-1] == f"{name} OK", text[-400:]
    return out, text


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name, capsys):
    out, text = _run(name, EXAMPLES[name], capsys)
    if name == "configure_from_model":
        from repro.core.configurator import configure
        from repro.core.traffic import TrafficSpec
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        want = configure(TrafficSpec(**dataclasses.asdict(mod.SPEC)),
                         **mod.SWEEP)
        assert [dataclasses.asdict(c) for c in out] == [
            dataclasses.asdict(c) for c in want]
    if name == "mrc_curve":
        assert "bit-identical to the scan engine: True" in text
    if name == "end_to_end":
        assert "lam_eff=86.6 (published: 86.6)" in text
    if name == "serve_paged":  # 31 decode steps past 4 x 32-token prompts
        assert out["lengths"] == [63] * 4 and out["t2_reads"] > 0
        assert np.isfinite(out["logprobs"]).all()


def test_train_tiered_runs_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out, text = _run("train_tiered", ["--steps", "12"], capsys)
    assert np.isfinite(out["final_loss"]) and len(out["losses"]) == 12
    assert (tmp_path / "ckpt" / "fast").is_dir()
    out2, text2 = _run("train_tiered", ["--steps", "14"], capsys)
    assert "[restore] resumed from step 10" in text2
    assert len(out2["losses"]) == 4
