"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 espnbench/run.py --workload espn-1m.batch64 --seed 7 \\
        --seconds 40 --trace 0

Run from the root of a checkout. The last line on standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; last, ``checks``: each
number compared against the reference, with its limit). The same numbers
are the last lines on standard error. Without a CUDA card, or with fewer
cards than the cell asks for, or with JAX or the JAX package loaded after
the window, it prints no result and exits with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"

# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernels build into build/kernels/)
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["USE_FLAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from espnbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device is visible; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell asks for {cell['chips']} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(bench, args.workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not be loaded are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
