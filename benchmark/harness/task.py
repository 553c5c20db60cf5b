"""A configuration's files: its dictionary, the seeded model directory
and its LM, as both the port and the reference load them.  The weights
are those of the configuration's `model.model_type`
(`inputs/models/<model_type>.py`).

What depends on the configuration alone (the dictionary over an LM's
vocabulary, the text mdef) is kept in `build/bench_cache/<config>/` in
the checkout, so that only a checkout's first run writes it; the seeded
weights are written anew into the run's own directory."""

from __future__ import annotations

import hashlib
import os
import time

from ..inputs import synth
from .cells import ROOT, feat_type, model_type


def cache_dir(conf: dict):
    d = ROOT / "build" / "bench_cache" / conf["name"]
    d.mkdir(parents=True, exist_ok=True)
    return d


def _atomic_write(path, text: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def dictionary(conf: dict) -> str:
    d = conf["dictionary"]
    if "file" in d:
        return str(ROOT / d["file"])
    path = cache_dir(conf) / "lm_vocab.dic"
    if not path.exists():
        tmp = f"{path}.{os.getpid()}.tmp"
        synth.dictionary_for_lm(str(ROOT / d["for_lm"]),
                                str(ROOT / d["base"]), tmp,
                                seed=d.get("seed", 0))
        os.replace(tmp, path)
    return str(path)


def prepare(conf: dict, seed: int, workdir: str) -> dict:
    """The task's files for `seed`: {"hmm", "dict", "lm", "noisedict",
    "seconds"}.  The streams the model type writes have to be those the
    configuration declares (`model.featlen`, or `model.n_feat` x
    `model.dim`) and the widths of its `feat`; nothing is written
    otherwise."""
    t0 = time.perf_counter()
    m, weights = conf["model"], model_type(conf).make_weights
    widths = feat_type(conf).FEATLEN
    dic = dictionary(conf)
    key = hashlib.sha256(open(dic, "rb").read()
                         + f"{m['n_sen']},{m['n_state']}".encode())
    mdef_path = cache_dir(conf) / f"mdef-{key.hexdigest()[:16]}.txt"
    if not mdef_path.exists():
        _atomic_write(mdef_path, synth.make_mdef([dic], m["n_sen"],
                                                 m["n_state"]))
    spec = weights(mdef_path.read_text(), int(seed) % (1 << 63), m,
                   conf["feat"])
    declared = list(m.get("featlen") or [m["dim"]] * m["n_feat"])
    if not spec.streams == declared == widths:
        raise ValueError(
            f"model streams {spec.streams} (written by model.model_type = "
            f"{m['model_type']!r}; declared {declared}) are not the widths "
            f"{widths} of feat = {conf['feat']!r}")
    hmm = spec.write_model_dir(os.path.join(workdir, "hmm"))
    return dict(hmm=hmm, dict=dic, lm=str(ROOT / conf["lm"]),
                noisedict=os.path.join(hmm, "noisedict"),
                seconds=time.perf_counter() - t0)


def model_sha256(hmm: str) -> str:
    """One SHA-256 over the model directory's files: each file's name and
    its own SHA-256, in name order."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(hmm)):
        with open(os.path.join(hmm, name), "rb") as f:
            h.update(f"{name} {hashlib.sha256(f.read()).hexdigest()}\n"
                     .encode())
    return h.hexdigest()
