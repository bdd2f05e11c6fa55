"""Helpers of the benchmark's tests: the checkout's root and the program on
the path, and tiny cells that run on the CPU in well under a second."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Each of the benchmark's configurations at a size for the CPU: every
# width cut, the published structure kept.
TINY = dict(hidden_size=64, head_dim=16, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=2, vocab_size=512)
TINY_TRAFFIC = dict(loop="closed", batch=8, prompt_tokens=32,
                    new_tokens=16, prompt_ids="uniform", tier1_share=0.5,
                    promote_every=4, promote_pages=2, kv_dtype="auto")
# The f32 reference's gaps at this size, seeds 0 to 29 and three large
# ones: the dense bf16 program's widest 0 to 0.0049 (4 requests sampled),
# the fp8 control's 0.032 to 0.12. An expert layer's routing flips where
# bf16 rounding reorders two near-tied experts, and a flipped token's
# logits move as far as the control's do (the MoE program's widest gap
# 0.0005 to 0.28, the control's 0.13 to 0.50), so its cells compare the
# mean gap: the program's at most 0.0031, the control's at least 0.0077.
TINY_LIMITS = {"logit_gap_max": 0.015}
TINY_MOE_LIMITS = {"logit_gap_mean": 0.005}


def tiny_config(name: str, base: str, **over) -> dict:
    """``configs/<base>.json`` at the tiny widths, with ``over`` on top."""
    c = json.loads((ROOT / "port_bench" / "configs"
                    / f"{base}.json").read_text())
    c.update(TINY, name=name, **over)
    c["assumed"] = dict(c["assumed"], kv_page_tokens=16)
    if c.get("num_local_experts"):
        c["num_local_experts"] = 4
    return c


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def add_cell(root: Path, cell: str, config: dict, traffic: str = "tiny",
             limits: dict = TINY_LIMITS) -> None:
    """A configuration, a cell and its entry in ``BENCHMARK.json``, added
    to the copy at ``root`` as new files and entries only."""
    pb = root / "port_bench"
    write(pb / "configs" / f"{config['name']}.json", config)
    write(pb / "workloads" / f"{cell}.json",
          dict(config=config["name"], traffic=traffic, chips=1, why="tiny",
               check=dict(sample_requests=4, limits=limits)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=cell, config=config["name"],
                                   traffic=traffic, chips=1, why="tiny"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    write(root / "BENCHMARK.json", bench)
