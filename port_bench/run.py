"""Run one cell of the benchmark of ``repro_torch`` on this machine's cards.

    python3 port_bench/run.py --workload nemo-3k-2tier --seed 1 \\
        --seconds 40 --trace 0

Prints the run's result as one JSON object on the last line of standard
output, after each number the output check compared, beside its limit, on
the last lines of standard error. With ``--trace 0`` the metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones. Exits with
a code other than 0, and prints no result, where the cell's cards are not
there, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# Kernel and build caches inside the checkout, at fixed paths (the
# program builds its own CUDA sources into <checkout>/build).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "port_bench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run(ROOT, cell, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START)
    leaked = harness.jax_modules()
    if leaked:
        print(f"loaded in the benchmark's process: {leaked}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
