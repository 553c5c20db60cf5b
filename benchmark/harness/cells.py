"""A cell, resolved by name: its entry in `BENCHMARK.json`, its
configuration file, its traffic mix (`traffic/<mix>.json`, which also
holds the limits of the check) and the metrics it reports.  Everything
that belongs to one configuration, mix, per-layer metric, model type or
feature type is a file of its own, found by its name: a metric's reader
`metrics/<name>.py`, the weights of the configuration's
`model.model_type` in `inputs/models/<model_type>.py`, the reference's
features of its `feat` in `reference/feat/<feat>.py`.  Adding a cell adds
files and entries and edits none."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path | None = None,
              traffic_dir: Path | None = None) -> Cell:
    """The cell `name` of the benchmark file at `spec_path` (default
    `BENCHMARK.json` at the root of the checkout), its mix from
    `traffic/` (or from `traffic_dir` where that holds it: tests give
    mixes of their own).  Relative paths are taken from the checkout's
    root."""
    root = ROOT
    spec_path = Path(spec_path or root / "BENCHMARK.json")
    spec = json.loads(spec_path.read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    w = work[name]
    confs = {c["name"]: c for c in spec["configs"]}
    conf = dict(json.loads((root / confs[w["config"]]["file"]).read_text()))
    conf["name"] = w["config"]
    check_data(conf, root)
    mix_file = f"{w['traffic']}.json"
    if traffic_dir is not None and (Path(traffic_dir) / mix_file).exists():
        mix = json.loads((Path(traffic_dir) / mix_file).read_text())
    else:
        mix = json.loads((BENCH / "traffic" / mix_file).read_text())
    mix["name"] = w["traffic"]
    return Cell(name=name, chips=int(w["chips"]), config=conf, mix=mix,
                limits=mix["limits"],
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, name)])


def check_data(conf: dict, root: Path):
    """Each data file the configuration names has the SHA-256 it gives,
    so that a change to the repository's data cannot move the yardstick
    unseen."""
    for rel, digest in conf.get("data_sha256", {}).items():
        got = hashlib.sha256((root / rel).read_bytes()).hexdigest()
        if got != digest:
            raise ValueError(f"{rel}: SHA-256 {got} != {digest} in the "
                             f"configuration {conf['name']}")


def by_name(folder: str, name, key: str):
    """The module `<folder>/<name>.py` under the benchmark's folder,
    loaded from its file.  A name with no file fails, by the key that
    gave it: nothing falls back to another file."""
    path = BENCH / folder / f"{name}.py"
    if not (isinstance(name, str) and NAME.fullmatch(name)
            and path.is_file()):
        raise ValueError(f"{key} = {name!r}: no file "
                         f"benchmark/{folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder.replace('/', '.')}.{name.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    return by_name("metrics", name, "per_layer name").read


def model_type(conf: dict):
    """The module of the configuration's `model.model_type`
    (`inputs/models/<model_type>.py`): its `make_weights`."""
    return by_name("inputs/models", conf["model"]["model_type"],
                   "model.model_type")


def feat_type(conf: dict):
    """The module of the configuration's `feat`
    (`reference/feat/<feat>.py`): the reference's `features` and the
    streams' widths `FEATLEN`."""
    return by_name("reference/feat", conf["feat"], "feat")
