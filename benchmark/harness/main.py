"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics, and the result's line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number compared with its limit);
an earlier line gives the set-up's parts.  The last lines of standard
error repeat the numbers compared beside their limits.  The run fails,
and prints no result, without as many CUDA cards as the cell asks for,
or when JAX or the JAX package is loaded once the window has closed."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from .cells import ROOT, load_cell, metric_reader
from .guard import forbidden_modules


def _entry_points():
    from .corpus import Corpus
    from .stream import Stream
    return {"corpus": Corpus, "stream": Stream}


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env():
    """Every build and kernel cache at a fixed path in the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


def main(argv=None, t_start=None, allow_cpu=False, spec_path=None,
         traffic_dir=None, out=None, err=None) -> int:
    """Run the cell; returns the exit code.  `allow_cpu`, `spec_path` and
    `traffic_dir` are for tests: a run on the CPU where there is no
    card, and cells and mixes of their own."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)
    cache_env()
    cell = load_cell(args.workload, spec_path, traffic_dir)
    import torch
    cuda = torch.cuda.is_available()
    if not cuda or torch.cuda.device_count() < cell.chips:
        if not allow_cpu:
            print(f"{cell.name}: needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available()={cuda}, "
                  f"device_count={torch.cuda.device_count() if cuda else 0}",
                  file=err)
            return 2
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    with tempfile.TemporaryDirectory(prefix="bench-") as work:
        return _run(cell, args, device, work, t_start, out, err)


def _run(cell, args, device, work, t_start, out, err) -> int:
    import torch
    drv = _entry_points()[cell.mix["kind"]](cell, args.seed, device, work)
    parts = drv.setup()
    setup_s = time.perf_counter() - t_start
    parts["imports_s"] = setup_s - sum(parts.values())
    print(json.dumps({"setup_parts": parts, "setup_s": setup_s}), file=out,
          flush=True)
    res = drv.window(args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        return 3
    got = drv.port_outputs()
    drv.free()
    t0 = time.perf_counter()
    ref = drv.reference()
    readings = drv.compare(got, ref)
    check_s = time.perf_counter() - t0
    lim = cell.limits
    missing = sorted(set(readings) - set(lim))
    if missing:
        print(f"no limit for {', '.join(missing)}", file=err)
        return 4
    checks = {k: {"value": v, "limit": lim[k]} for k, v in readings.items()}
    correct = all(v <= lim[k] for k, v in readings.items())
    metrics = {}
    if args.trace:
        ctx = drv.layer_context(res, ref)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(res["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": 0,
            "metrics": metrics, "device": dev}
    tr = res.get("trace")
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.top_ops(10),
                             "idle_gaps": tr.idle_gaps[:10]}
    line["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        return 3
    print(f"check: {check_s:.1f} s, {'correct' if correct else 'NOT correct'}",
          file=err)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
