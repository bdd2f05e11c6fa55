"""The plain reference: what it imports, and how close the port's served
tokens come to it at each configuration's reduced size on the CPU."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from port_bench import check, control, harness
from port_bench.reference import common

from pb_tiny import (ROOT, TINY_LIMITS, TINY_MOE_LIMITS, TINY_TRAFFIC,
                     tiny_config)

CONFIGS = ("mistral-nemo-12b", "mixtral-8x22b")
# Each configuration's tiny traffic and the number its cells compare.
TINY = {"mistral-nemo-12b": TINY_LIMITS, "mixtral-8x22b": TINY_MOE_LIMITS}


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import port_bench.reference.common, port_bench.reference.gqa\n"
        "import port_bench.reference.swiglu, port_bench.reference.moe\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'repro', 'repro_torch', 'jax', 'jaxlib', "
        "'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", CONFIGS)
def test_port_config_departs_only_where_the_file_says(name):
    """The program's configuration of the file differs from its
    ``configs/archs.py`` entry in the sizes cut (``reduced``) and in the
    departures the file lists, and nowhere else."""
    from repro_torch.configs.archs import get_config
    config = json.loads((ROOT / "port_bench" / "configs"
                         / f"{name}.json").read_text())
    ours = harness.port_config(config)
    theirs = get_config(config["port_arch"])
    differ = {f.name for f in dataclasses.fields(ours)
              if getattr(ours, f.name) != getattr(theirs, f.name)}
    cut = {"n_layers"} if config["reduced"] else set()
    assert differ - {"name", "moe"} == \
        set(config["departs_from_port_arch"]) | cut
    if ours.moe is not None:   # the capacity factor is the port's default
        assert ours.moe == theirs.moe


def _round(config: dict, seed: int, traffic: dict, limits: dict):
    cell = dict(name="t", config_data=config, traffic_data=traffic,
                chips=1, check=dict(sample_requests=4, limits=limits))
    params = harness.make_weights(config, seed, "cpu")
    server = harness.Server(cell, "cpu")
    rec = harness.window(server, params, seed, 0.0)
    return cell, params, rec


@pytest.mark.parametrize("name,over", [
    ("mistral-nemo-12b", {}),
    ("mixtral-8x22b", {}),
    # Capacity a quarter of the even share: the prefill drops slots, so
    # the reference has to drop the same ones.
    ("mixtral-8x22b", {"assumed": {"kv_page_tokens": 16,
                                   "moe_capacity_factor": 0.25}}),
])
@pytest.mark.parametrize("seed", [5, 2**31 + 6])
def test_port_serves_what_the_reference_predicts(name, over, seed):
    config = tiny_config("tiny", name)
    config.update(over)
    limits = TINY[name]
    cell, params, rec = _round(config, seed, TINY_TRAFFIC, limits)
    numbers, per_request = check.judge(cell, params, rec["rounds"], seed,
                                       "cpu")
    assert all(numbers[k] <= v for k, v in limits.items())
    assert len(per_request["logit_gap_max"]) == (
        TINY_TRAFFIC["batch"] if config.get("num_local_experts") else 4)


def test_capacity_drops_at_the_reduced_size():
    """The case above with a quarter of the even share does drop slots."""
    m = common.dims(tiny_config("tiny", "mixtral-8x22b"))
    h = torch.randn(64, m["d"])
    w = torch.randn(m["d"], m["experts"])
    from port_bench.reference import moe
    _, weights = moe.route(h, w, m, 0.25)
    assert 0 < int((weights == 0).sum()) < weights.numel()


@pytest.mark.parametrize("name", CONFIGS)
def test_fp8_control_fails_the_limit(name):
    """The control (the reference through fp8) comes out not correct at
    the test size, on the number the configuration's cells compare, which
    the port's served tokens meet."""
    config = tiny_config("tiny", name)
    limits = TINY[name]
    for seed in (5, 6, 7):
        cell, params, rec = _round(config, seed, TINY_TRAFFIC, limits)
        prog, ctrl = control.control_gaps(cell, params, rec["rounds"], seed,
                                          "cpu")
        for key, limit in limits.items():
            assert control.stats(prog)[key] <= limit
            assert control.stats(ctrl)[key] > limit
