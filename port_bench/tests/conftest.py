"""Fixtures of the benchmark's tests."""
from __future__ import annotations

import shutil
from pathlib import Path

import pytest

from pb_tiny import ROOT, TINY_MOE_LIMITS, TINY_TRAFFIC, add_cell, tiny_config, write


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark with the tiny cells ``tiny-dense`` and
    ``tiny-moe`` beside the real ones."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    write(root / "port_bench" / "traffic" / "tiny.json", TINY_TRAFFIC)
    add_cell(root, "tiny-dense", tiny_config("tiny-nemo",
                                             "mistral-nemo-12b"))
    add_cell(root, "tiny-moe", tiny_config("tiny-mixtral", "mixtral-8x22b"),
             limits=TINY_MOE_LIMITS)
    return root


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
