#!/usr/bin/env python3
"""Run one cell of the benchmark of `tpupose_torch` on the CUDA card(s) of
this machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload bf16-clip32 --seed 7 --seconds 10 --trace 0

The cells, their configurations, traffic and metrics are named in
`BENCHMARK.json` at the root of the checkout; `benchmark/harness.py` finds
their files by those names. Without enough CUDA cards it prints no result
and exits non-zero.
"""
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T0))
