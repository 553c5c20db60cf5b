"""The control of a cell's check: the reference put in the program's
place and computed in the precision below the configuration's (TF32
products for float32 with TF32 off), compared with the float32
reference by the cell's own numbers, on each seed given.  Each seed's
numbers must fail the cell's limits: they are the upper readings the
limits were set below.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

Prints one JSON line per seed.  The benchmark's own runs do not run
it."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark.harness.cells import load_cell  # noqa: E402
from benchmark.harness.main import _entry_points, cache_env  # noqa: E402


def control(cell, seed: int, device, work: str) -> dict:
    drv = _entry_points()[cell.mix["kind"]](cell, seed, device, work)
    drv.inputs()
    t0 = time.perf_counter()
    ref = drv.reference(tf32=False)
    low = drv.reference(tf32=True)
    lim = cell.limits
    readings = drv.compare(low, ref)
    return dict(seed=seed, seconds=time.perf_counter() - t0,
                readings=readings,
                fails=[k for k, v in readings.items() if v > lim.get(k, 0)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    cache_env()
    cell = load_cell(a.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="bench-ctl-") as work:
            print(json.dumps(control(cell, seed, device, work)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
