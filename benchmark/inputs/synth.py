"""Seeded synthetic acoustic model at en-us's published shapes, seeded
PCM, and a dictionary over an LM's vocabulary.

A frozen copy of `make_model`, `dictionary_for_lm` and `make_pcm` (with
the helpers they call) from `pocketsphinx_tpu_torch/testing/synth.py` at
commit 877b0e812f03b9328e7049cc92b93a2d85380b01, so that a later change
to the port's test helpers does not move the benchmark's inputs.  Two
changes, neither of which changes a byte of what is written:
`make_model` is split into `make_mdef` (the text model definition,
which depends on the dictionaries alone) and `make_weights` (the seeded
arrays), so that a run can keep the first in its cache; and
`dictionary_for_lm` reads the LM's vocabulary through the reference's
reader (`benchmark.reference.psref`), not the port's.  Since then, so
that other model types (`inputs/models/<model_type>.py`) write through
the same code, `write_model_dir` also writes streams of unequal widths
(`SynthModel.featlen`) and another feature type's `feat.params`
(`feat_params`), and the transitions are drawn by `make_tmat`; the PTM
model's files are the same bytes as before.

The model is the structure of pocketsphinx's en-us PTM model: 42 CI
phones (the 39 CMUdict phones, SIL, +NSN+, +SPN+), 3 emitting states,
42 codebooks x 3 streams x 128 densities x 13 dims, 5,126 senones of
which 126 are CI, and a text mdef covering every triphone that the
dictionaries need, its CD senones tied per (base phone, state).
`write_model_dir` writes the files that both the port and the reference
load: `mdef`, the Sphinx-3 binary `means`, `variances`,
`mixture_weights` and `transition_matrices`, `noisedict` and en-us's
`feat.params`.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass

import numpy as np

PHONES = ("AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG "
          "OW OY P R S SH T TH UH UW V W Y Z ZH").split()
FILLERS = ("+NSN+", "+SPN+")
SIL = "SIL"
NOISEDICT = ("<s> SIL\n</s> SIL\n<sil> SIL\n[NOISE] +NSN+\n"
             "[SPEECH] +SPN+\n")
#: en-us shapes (5126 senones, 126 CI; PTM 42 x 3 x 128 x 13)
EN_US = dict(n_sen=5126, n_density=128, n_feat=3, dim=13)
#: en-us's feat.params
FEAT_PARAMS = ("-lowerf 130\n-upperf 6800\n-nfilt 25\n-transform dct\n"
               "-lifter 22\n-feat 1s_c_d_dd\n-svspec 0-12/13-25/26-38\n"
               "-agc none\n-cmn live\n-varnorm no\n-model ptm\n")
#: log base of the model files' scores (logmath base 1.0001, >> 10)
_UNIT_NATS = float(np.log(1.0001)) * 1024


def read_prons(dict_path: str) -> list[list[str]]:
    """Phone strings of every pronunciation in a dictionary file."""
    prons = []
    for line in open(dict_path, encoding="utf-8", errors="replace"):
        parts = line.split()
        if parts and not parts[0].startswith(("##", ";;")):
            prons.append(parts[1:])
    return prons


def _triphones(prons):
    """(base, left, right, wpos) rows the pronunciations need, in a
    deterministic order."""
    firsts = sorted({p[0] for p in prons}) + [SIL]      # right contexts
    lasts = sorted({p[-1] for p in prons}) + [SIL]      # left contexts
    rows = set()
    for p in prons:
        if len(p) == 1:
            rows.update((p[0], lc, rc, "s") for lc in lasts for rc in firsts)
            continue
        rows.update((p[0], lc, p[1], "b") for lc in lasts)
        rows.update((p[j], p[j - 1], p[j + 1], "i")
                    for j in range(1, len(p) - 1))
        rows.update((p[-1], p[-2], rc, "e") for rc in firsts)
    return sorted(rows)


@dataclass
class SynthModel:
    mdef_text: str
    means: np.ndarray          # [42, F, D, L] f32
    var: np.ndarray            # [42, F, D, L] f32
    mixw: np.ndarray           # [F, D, n_sen] uint8 costs
    tmat: np.ndarray           # [42, N, N+1] uint8 costs (255 = impossible)
    #: each stream's width where they differ (None: all L); the lanes of
    #: `means` and `var` past a stream's width are not written
    featlen: list | None = None
    feat_params: str = FEAT_PARAMS

    @property
    def streams(self) -> list:
        """Each stream's width, as written."""
        return list(self.featlen or [self.means.shape[-1]]
                    * self.means.shape[1])

    def write_model_dir(self, directory: str) -> str:
        """Write the model directory; returns `directory`."""
        os.makedirs(directory, exist_ok=True)
        n_cb, n_feat, n_den, dim = self.means.shape
        with open(os.path.join(directory, "mdef"), "w") as f:
            f.write(self.mdef_text)
        with open(os.path.join(directory, "noisedict"), "w") as f:
            f.write(NOISEDICT)
        with open(os.path.join(directory, "feat.params"), "w") as f:
            f.write(self.feat_params)
        featlen = self.streams
        for name, x in (("means", self.means), ("variances", self.var)):
            if featlen != [dim] * n_feat:     # on disk [cb][f][d][featlen[f]]
                x = np.concatenate([x[c, j, :, :L].reshape(-1)
                                    for c in range(n_cb)
                                    for j, L in enumerate(featlen)])
            _write_s3(os.path.join(directory, name),
                      [n_cb, n_feat, n_den] + featlen, x)
        # mixture weights [n_sen, n_feat, n_den] and transitions
        # [n_tmat, N, N+1] as probabilities (cost 255 = impossible)
        mixw = np.exp(-self.mixw.astype(np.float64) * _UNIT_NATS)
        _write_s3(os.path.join(directory, "mixture_weights"),
                  [self.mixw.shape[2], n_feat, n_den],
                  mixw.transpose(2, 0, 1))
        tp = np.where(self.tmat == 255, 0.0,
                      np.exp(-self.tmat.astype(np.float64) * _UNIT_NATS))
        _write_s3(os.path.join(directory, "transition_matrices"),
                  list(tp.shape), tp)
        return directory


def _write_s3(path: str, ints, data):
    """A Sphinx-3 binary file: the text header (with `chksum0`),
    `endhdr`, the byte-order word, the int32 dimensions, the float32
    count and data, and the checksum over everything after the byte-order
    word (src/util/bio.c)."""
    ints = np.asarray(list(ints) + [np.size(data)], "<i4")
    data = np.ascontiguousarray(data, "<f4").reshape(-1)
    chk = 0
    for v in np.concatenate([ints.view("<u4"), data.view("<u4")]).tolist():
        chk = (((chk << 20) | (chk >> 12)) + v) & 0xFFFFFFFF
    with open(path, "wb") as f:
        f.write(b"s3\nversion 1.0\nchksum0 yes\nendhdr\n")
        f.write(np.array([0x11223344], "<u4").tobytes())
        f.write(ints.tobytes())
        f.write(data.tobytes())
        f.write(np.array([chk], "<u4").tobytes())


def make_mdef(dict_paths, n_sen: int = EN_US["n_sen"], n_state: int = 3
              ) -> str:
    """The text mdef of `make_model` (no randomness in it)."""
    ci = PHONES + [SIL, *FILLERS]
    speech = set(PHONES)
    n_ci = len(ci)
    N = n_state
    n_ci_sen = N * n_ci
    prons = [p for path in dict_paths for p in read_prons(path)
             if all(x in speech for x in p) and p]
    rows = _triphones(prons)
    # CD senone pools per (base, state), sized by how many triphones use
    # the base, each at most that count so every pool entry gets used
    bases = sorted({r[0] for r in rows})
    count = Counter(r[0] for r in rows)
    n_cd = n_sen - n_ci_sen
    if n_cd < N * len(bases) or n_cd > N * len(rows):
        raise ValueError(f"n_sen={n_sen} does not fit {len(rows)} triphones "
                         f"over {len(bases)} base phones")
    keys = [(b, j) for b in bases for j in range(N)]
    spare = n_cd - len(keys)
    size = {k: 1 + min(count[k[0]] - 1, spare * count[k[0]] // (N * len(rows)))
            for k in keys}
    left = n_cd - sum(size.values())
    while left > 0:          # hand out the remainder, most-used first
        for k in sorted(keys, key=lambda k: size[k] - count[k[0]]):
            if left and size[k] < count[k[0]]:
                size[k] += 1
                left -= 1
    start, nxt = {}, n_ci_sen
    for k in keys:
        start[k], nxt = nxt, nxt + size[k]
    used = {k: 0 for k in keys}

    def senones(b):
        out = []
        for j in range(N):
            k = (b, j)
            out.append(start[k] + used[k] % size[k])
            used[k] += 1
        return out

    lines = ["0.3", f"{n_ci} n_base", f"{len(rows)} n_tri",
             f"{(n_ci + len(rows)) * (N + 1)} n_state_map",
             f"{n_sen} n_tied_state",
             f"{n_ci_sen} n_tied_ci_state", f"{n_ci} n_tied_tmat", "#"]
    cidx = {p: i for i, p in enumerate(ci)}
    for i, p in enumerate(ci):
        attrib = "filler" if p in (SIL, *FILLERS) else "n/a"
        states = " ".join(str(N * i + j) for j in range(N))
        lines.append(f"{p} - - - {attrib} {i} {states} N")
    for b, lc, rc, wp in rows:
        states = " ".join(str(x) for x in senones(b))
        lines.append(f"{b} {lc} {rc} {wp} n/a {cidx[b]} {states} N")
    return "\n".join(lines) + "\n"


def make_weights(mdef_text: str, seed: int = 0,
                 n_sen: int = EN_US["n_sen"],
                 n_density: int = EN_US["n_density"],
                 n_feat: int = EN_US["n_feat"], dim: int = EN_US["dim"],
                 n_state: int = 3) -> SynthModel:
    """`make_model`'s seeded arrays over a `make_mdef` text."""
    rng = np.random.default_rng(seed)
    n_ci = len(PHONES) + 1 + len(FILLERS)
    N = n_state
    means = rng.standard_normal((n_ci, n_feat, n_density, dim),
                                dtype=np.float32)
    var = rng.uniform(0.3, 2.0, (n_ci, n_feat, n_density, dim)
                      ).astype(np.float32)
    # mixture-weight costs: a few likely densities per senone
    mixw = rng.integers(60, 160, (n_feat, n_density, n_sen)).astype(np.uint8)
    hot = rng.integers(0, n_density, (n_feat, 8, n_sen))
    np.put_along_axis(mixw, hot, rng.integers(0, 30, hot.shape)
                      .astype(np.uint8), axis=1)
    return SynthModel(mdef_text=mdef_text, means=means, var=var, mixw=mixw,
                      tmat=make_tmat(rng, n_ci, N))


def make_tmat(rng, n_ci: int, N: int) -> np.ndarray:
    """Transition costs [n_ci, N, N+1] (255 = impossible): left to right
    with self-loops, and rare skips (j -> j+2) from state 0 at 3 states,
    from every state that has one at 5."""
    tmat = np.full((n_ci, N, N + 1), 255, np.uint8)
    for j in range(N):
        tmat[:, j, j] = rng.integers(1, 12, n_ci)
        tmat[:, j, j + 1] = rng.integers(1, 12, n_ci)
    for j in range(1 if N == 3 else N - 1):
        tmat[:, j, j + 2] = rng.integers(20, 60, n_ci)
    return tmat


def feat_params(feat: str, model_type: str) -> str:
    """en-us's `feat.params` with the feature type and model type given
    (`FEAT_PARAMS` itself for a PTM model over 1s_c_d_dd); the stream
    split (`-svspec`) is en-us's for 1s_c_d_dd, and absent for another
    feature type, which has streams of its own."""
    text = (FEAT_PARAMS.replace("-feat 1s_c_d_dd\n", f"-feat {feat}\n")
            .replace("-model ptm\n", f"-model {model_type}\n"))
    if feat != "1s_c_d_dd":
        text = text.replace("-svspec 0-12/13-25/26-38\n", "")
    return text


def make_model(dict_paths, seed: int = 0, n_sen: int = EN_US["n_sen"],
               n_density: int = EN_US["n_density"],
               n_feat: int = EN_US["n_feat"], dim: int = EN_US["dim"],
               n_state: int = 3) -> SynthModel:
    """A seeded PTM model whose mdef covers the triphones of every
    pronunciation in `dict_paths`, with `n_state` emitting states per
    phone: left to right with self-loops, and skips (j -> j+2) from
    state 0 at 3 states, from every state that has one at 5."""
    return make_weights(make_mdef(dict_paths, n_sen, n_state), seed, n_sen,
                        n_density, n_feat, dim, n_state)


def make_pcm(seed: int, seconds: float, samprate: int = 16000) -> np.ndarray:
    """Seeded int16 PCM: voiced segments (harmonic tones with gliding
    pitch and formant-like weights) between pauses, over low noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * samprate)
    t = np.arange(n) / samprate
    x = rng.normal(0.0, 30.0, n)
    pos = int(rng.uniform(0.1, 0.3) * samprate)
    while pos < n - samprate // 10:
        seg = int(rng.uniform(0.15, 0.5) * samprate)
        end = min(pos + seg, n)
        tt = t[pos:end] - t[pos]
        f0 = rng.uniform(90, 220) * (1 + 0.2 * np.sin(2 * np.pi * tt
                                                       * rng.uniform(1, 4)))
        phase = 2 * np.pi * np.cumsum(f0) / samprate
        env = np.sin(np.pi * np.arange(end - pos) / (end - pos)) ** 2
        formants = rng.uniform(300, 3000, 3)
        voiced = sum(np.exp(-((k * f0 - formants[:, None]) / 400.0) ** 2)
                     .sum(0) * np.sin(k * phase) for k in range(1, 25))
        x[pos:end] += 2500.0 * env * voiced / 3.0
        pos = end + int(rng.uniform(0.05, 0.3) * samprate)
    return np.clip(x, -32768, 32767).astype(np.int16)


def dictionary_for_lm(lm_path: str, base_dic: str, out: str,
                      seed: int = 0) -> str:
    """Write a dictionary with one pronunciation for every word of the LM
    at `lm_path` (the sentence markers excepted, which the noise
    dictionary holds): a word of `base_dic` keeps its own (first)
    pronunciation; every other word takes that of a seeded-random
    `base_dic` word, whose homophone it becomes.  Returns `out`."""
    from ..reference.psref.lm.ngram import read_lm

    base = {}
    for line in open(base_dic, encoding="utf-8", errors="replace"):
        parts = line.split()
        if parts and not parts[0].startswith(("##", ";;")):
            base.setdefault(parts[0], " ".join(parts[1:]))
    prons = list(base.values())
    words = [w for w in read_lm(lm_path).words if w not in ("<s>", "</s>")]
    pick = np.random.default_rng(seed).integers(0, len(prons), len(words))
    with open(out, "w") as f:
        f.writelines(f"{w} {base.get(w) or prons[i]}\n"
                     for w, i in zip(words, pick))
    return out
