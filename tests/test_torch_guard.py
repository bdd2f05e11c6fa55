"""Package boundaries of the port: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor the reference package, the port runs with JAX made
unimportable, and its entry points default to the card without falling
back to the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro_torch.sim as T
from repro_torch.core.traffic import TrafficSpec
from repro_torch.storage.tiered_store import StoreConfig, run_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
    r"import\s+repro\s*$|from\s+repro\s+import)", re.M)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "src" / "repro_torch").rglob("*.cu"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), path
        for needle in ("import jax", "from jax", "import repro.",
                       "from repro."):
            assert needle not in text, f"{path}: {needle}"


_SMALL = TrafficSpec(kind="irm", n_requests=300, n_pages=120, seed=2)


def test_simulate_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.sim as T\n"
        "from repro_torch.core.traffic import TrafficSpec\n"
        "from repro_torch.storage.tiered_store import StoreConfig\n"
        "rep = T.simulate(T.SimSpec(traffic=TrafficSpec(kind='irm', "
        "n_requests=300, n_pages=120, seed=2), store=StoreConfig("
        "n_lines=16), n_shards=2), device='cpu')\n"
        "assert rep.requests == 300\n"
        "print('OK')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = T.SimSpec(traffic=_SMALL, store=StoreConfig(n_lines=16),
                     n_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.simulate(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.tier1_counters(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_stream(StoreConfig(n_lines=8), [1, 2, 3], [False] * 3)
