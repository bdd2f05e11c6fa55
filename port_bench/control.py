"""The output check's control: the plain reference put in the program's place
one precision step below the configuration's bf16, in fp8 (e4m3: every
weight matrix with one scale a tensor, the keys and values with one a
token and head). At each position of the same prompts and served tokens,
the token the fp8 forward puts first is judged by the f32 reference's
logits, as the program's served token is.

The benchmark's runs do not run it. On the chip, for a cell at its own
size, it reads the numbers the limits are set from:

    python3 port_bench/control.py --workload nemo-3k-2tier --seeds 1 2 3

For each seed: the weights, one round of the program at the cell's load
(the window's own loop, closed after its first round), the program's
numbers (``check.judge``) and the control's, printed as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
E4M3_MAX = 448.0


def fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded through float8 e4m3 with one scale for the tensor,
    back in f32."""
    w = w.float()
    s = w.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x [..., hd]`` rounded through e4m3 with one scale a row."""
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def stats(g: torch.Tensor) -> dict:
    """The gap numbers of ``g [N, new]`` (f64 on the host)."""
    flat = g.flatten()
    q = torch.quantile(flat, torch.tensor([0.5, 0.9, 0.99, 0.999],
                                          dtype=flat.dtype))
    return dict(logit_gap_max=float(flat.max()),
                logit_gap_mean=float(flat.mean()),
                p50=float(q[0]), p90=float(q[1]), p99=float(q[2]),
                p999=float(q[3]), share_off=float((flat > 0).double().mean()),
                request_max_median=float(g.amax(1).median()))


def control_gaps(cell: dict, params: dict, rounds: list, seed: int,
                 device) -> tuple:
    """The program's gaps and the control's, ``[N, new]`` each, on the
    check's own sample."""
    from port_bench import check
    from port_bench.reference import common as ref
    r, idx = check.sample(cell, rounds, seed)
    tokens, served, groups = check.inputs(rounds, r, idx, device)
    s = rounds[r]["prompts"].shape[1]
    config = cell["config_data"]
    logits = ref.forward_logits(config, params, tokens, s - 1, groups)
    prog = check.gaps(logits, served)
    low = ref.forward_logits(config, params, tokens, s - 1, groups,
                             cast=fp8, kv_cast=fp8_rows)
    ctrl = check.gaps(logits, low.argmax(-1))
    return prog.double().cpu(), ctrl.double().cpu()


def main(argv=None) -> int:
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    from port_bench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    server = None
    for seed in args.seeds:
        t0 = time.perf_counter()
        params = harness.make_weights(cell["config_data"], seed % 2**63,
                                      "cuda")
        server = server or harness.Server(cell, "cuda")
        rec = harness.window(server, params, seed % 2**63, 0.0)
        prog, ctrl = control_gaps(cell, params, rec["rounds"],
                                  seed % 2**63, "cuda")
        print(json.dumps(dict(seed=seed, program=stats(prog),
                              control=stats(ctrl),
                              seconds=time.perf_counter() - t0)),
              flush=True)
        del params, rec
    return 0


if __name__ == "__main__":
    sys.exit(main())
