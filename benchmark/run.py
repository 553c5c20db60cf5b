"""Run one cell of the benchmark of pocketsphinx_tpu_torch once, from the
root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cells, metrics and bounds are in `BENCHMARK.json`; `harness/main.py`
says what a run prints."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, is where imports resolve
sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
