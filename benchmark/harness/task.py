"""A configuration's files: its dictionary, the seeded model directory
and its LM, as both the port and the reference load them.

What depends on the configuration alone (the dictionary over an LM's
vocabulary, the text mdef) is kept in `build/bench_cache/<config>/` in
the checkout, so that only a checkout's first run writes it; the seeded
weights are written anew into the run's own directory."""

from __future__ import annotations

import hashlib
import os
import time

from ..inputs import synth
from .cells import ROOT


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
    "seconds"}."""
    t0 = time.perf_counter()
    m = conf["model"]
    dic = dictionary(conf)
    key = hashlib.sha256(open(dic, "rb").read()
                         + f"{m['n_sen']},{m['n_state']}".encode())
    mdef_path = cache_dir(conf) / f"mdef-{key.hexdigest()[:16]}.txt"
    if not mdef_path.exists():
        _atomic_write(mdef_path, synth.make_mdef([dic], m["n_sen"],
                                                 m["n_state"]))
    spec = synth.make_weights(mdef_path.read_text(),
                              seed=int(seed) % (1 << 63), n_sen=m["n_sen"],
                              n_density=m["n_density"], n_feat=m["n_feat"],
                              dim=m["dim"], n_state=m["n_state"])
    hmm = spec.write_model_dir(os.path.join(workdir, "hmm"))
    return dict(hmm=hmm, dict=dic, lm=str(ROOT / conf["lm"]),
                noisedict=os.path.join(hmm, "noisedict"),
                seconds=time.perf_counter() - t0)
