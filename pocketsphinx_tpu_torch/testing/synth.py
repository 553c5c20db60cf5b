"""Seeded synthetic acoustic model at en-us's published shapes, and PCM.

The en-us model files are not in the repository, so the port's tests and
`chip_smoke.py` build a stand-in with the same structure from a seed:
42 CI phones (the 39 CMUdict phones, SIL, +NSN+, +SPN+), 3 emitting
states (or 5, `make_model(..., n_state=5)`), PTM with 42 codebooks x 3 streams x 128 densities x 13 dims,
and 5,126 senones of which 126 are CI.  The text model definition covers
every triphone that the given dictionaries need (word-begin, -internal,
-end and single-phone contexts); its CD senones are tied per (base
phone, state) so that every senone belongs to exactly one codebook.
`make_semi_model` gives a Sphinx-II semi-continuous model over the same
mdef instead: one codebook shared by every senone, over the s2_4x
streams of 12, 24, 3 and 12 lanes.

`SynthModel.write(directory)` writes the text mdef and the noise
dictionary; `SynthModel.load(directory)` builds this port's
`AcousticModel` from them.  Any other implementation that reads the same
files and takes the same arrays builds the same model.

`SynthModel.write_model_dir(directory)` writes a whole model directory,
as `Decoder(hmm=directory)` (of either package) loads it: the text
`mdef`, the Sphinx-3 binary `means`, `variances`, `mixture_weights` and
`transition_matrices`, `noisedict`, and a `feat.params` with en-us's
published front-end settings (`FEAT_PARAMS`).  The weights and
transitions are written as probabilities, so the loaders' normalization
and quantization apply to them as to a trained model.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..fileio import acoustic as fio
from ..fileio.bin_mdef import read_text_mdef
from ..fileio.dictionary import Dictionary
from ..lm.ngram import read_lm
from ..logmath import default_logmath
from ..models.acoustic import AcousticModel
from ..models.dict2pid import Dict2Pid
from ..search.ngram_fused import NgramFusedDecoder

PHONES = ("AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG "
          "OW OY P R S SH T TH UH UW V W Y Z ZH").split()
FILLERS = ("+NSN+", "+SPN+")
SIL = "SIL"
#: the names of the extra CI phones that `make_model(n_extra_phones=n)`
#: appends after the 42 (ids 42 .. 41 + n), and that
#: `small_dictionary(n_extra_phones=n)` writes into pronunciations
EXTRA_PHONE = "X{:02d}"
NOISEDICT = ("<s> SIL\n</s> SIL\n<sil> SIL\n[NOISE] +NSN+\n"
             "[SPEECH] +SPN+\n")
#: en-us shapes (SURVEY.md: 5126 senones, 126 CI; PTM 42 x 3 x 128 x 13)
EN_US = dict(n_sen=5126, n_density=128, n_feat=3, dim=13)
#: the stream widths of Sphinx-II's s2_4x features
S2_4X = (12, 24, 3, 12)
#: en-us's feat.params (the front end and feature type the model was
#: trained with; `-svspec` selects the three 13-dim streams)
FEAT_PARAMS = ("-lowerf 130\n-upperf 6800\n-nfilt 25\n-transform dct\n"
               "-lifter 22\n-feat 1s_c_d_dd\n-svspec 0-12/13-25/26-38\n"
               "-agc none\n-cmn live\n-varnorm no\n-model ptm\n")
#: log base of the model files' scores (logmath base 1.0001, >> 10)
_UNIT_NATS = float(np.log(1.0001)) * 1024
BENCH_DATA = Path(__file__).resolve().parents[2] / "bench_data"


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

    def write(self, directory: str) -> tuple[str, str]:
        """Write `mdef.txt` and `noisedict` into `directory`; returns
        their paths."""
        os.makedirs(directory, exist_ok=True)
        mdef_path = os.path.join(directory, "mdef.txt")
        noise_path = os.path.join(directory, "noisedict")
        with open(mdef_path, "w") as f:
            f.write(self.mdef_text)
        with open(noise_path, "w") as f:
            f.write(NOISEDICT)
        return mdef_path, noise_path

    def write_model_dir(self, directory: str) -> str:
        """Write a model directory that `AcousticModel.load` and the
        config's `-hmm` expansion read (see the module docstring);
        returns `directory`."""
        os.makedirs(directory, exist_ok=True)
        n_cb, n_feat, n_den, dim = self.means.shape
        with open(os.path.join(directory, "mdef"), "w") as f:
            f.write(self.mdef_text)
        with open(os.path.join(directory, "noisedict"), "w") as f:
            f.write(NOISEDICT)
        with open(os.path.join(directory, "feat.params"), "w") as f:
            f.write(self.feat_params)
        featlen = list(self.featlen or [dim] * n_feat)
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

    def load(self, directory: str, varfloor: float = 1e-4):
        """Write the model files into `directory` and build the port's
        `AcousticModel` from them.  Returns (model, path of the noise
        dictionary)."""
        mdef_path, noise_path = self.write(directory)
        n_cb, n_feat, n_den, dim = self.means.shape
        g = fio.Gauden(n_cb, n_feat, n_den, np.full(n_feat, dim, np.int32),
                       self.means, self.var)
        g.precompute(default_logmath(), varfloor)
        am = AcousticModel(
            mdef=read_text_mdef(mdef_path), gauden=g,
            mixw=fio.MixtureWeights(mixw=self.mixw, n_sen=self.mixw.shape[-1]),
            tmat=fio.Tmat(tp=self.tmat), model_type="ptm")
        return am, noise_path


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


def extra_phones(n: int) -> list[str]:
    """The names of `n` extra CI phones (`EXTRA_PHONE`)."""
    return [EXTRA_PHONE.format(i) for i in range(n)]


def make_model(dict_paths, seed: int = 0, n_sen: int = EN_US["n_sen"],
               n_density: int = EN_US["n_density"],
               n_feat: int = EN_US["n_feat"], dim: int = EN_US["dim"],
               n_state: int = 3, n_extra_phones: int = 0):
    """A seeded PTM model whose mdef covers the triphones of every
    pronunciation in `dict_paths`, with `n_state` emitting states per
    phone: left to right with self-loops, and skips (j -> j+2) from
    state 0 at 3 states, from every state that has one at 5.  With
    `n_extra_phones`, the phone set has that many more CI phones after
    the 42 (`extra_phones`; one codebook each), and `n_sen` counts their
    CI senones too."""
    rng = np.random.default_rng(seed)
    ci = PHONES + [SIL, *FILLERS] + extra_phones(n_extra_phones)
    speech = set(PHONES) | set(extra_phones(n_extra_phones))
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

    means = rng.standard_normal((n_ci, n_feat, n_density, dim),
                                dtype=np.float32)
    var = rng.uniform(0.3, 2.0, (n_ci, n_feat, n_density, dim)
                      ).astype(np.float32)
    # mixture-weight costs: a few likely densities per senone
    mixw = rng.integers(60, 160, (n_feat, n_density, n_sen)).astype(np.uint8)
    hot = rng.integers(0, n_density, (n_feat, 8, n_sen))
    np.put_along_axis(mixw, hot, rng.integers(0, 30, hot.shape)
                      .astype(np.uint8), axis=1)
    tmat = np.full((n_ci, N, N + 1), 255, np.uint8)
    for j in range(N):
        tmat[:, j, j] = rng.integers(1, 12, n_ci)
        tmat[:, j, j + 1] = rng.integers(1, 12, n_ci)
    for j in range(1 if N == 3 else N - 1):           # rare skips
        tmat[:, j, j + 2] = rng.integers(20, 60, n_ci)
    return SynthModel(mdef_text="\n".join(lines) + "\n", means=means,
                      var=var, mixw=mixw, tmat=tmat)


def make_semi_model(dict_paths, seed: int = 0, n_sen: int = 210 + 400,
                    n_density: int = 16, featlen=S2_4X, n_state: int = 5):
    """A seeded Sphinx-II semi-continuous model over `make_model`'s mdef
    and transitions: one codebook of `n_density` codewords shared by
    every senone, over streams of the widths `featlen` (s2_4x's 12, 24,
    3 and 12 by default), with a `feat.params` of en-us's front end and
    `-feat s2_4x` (no `-svspec`: the type has streams of its own).  Write
    it with `write_model_dir`; `AcousticModel.load` reads it as "semi"."""
    featlen = list(featlen)
    spec = make_model(dict_paths, seed=seed, n_sen=n_sen,
                      n_density=n_density, n_feat=len(featlen),
                      dim=max(featlen), n_state=n_state)
    rng = np.random.default_rng(seed + 1)
    F, L, D = len(featlen), max(featlen), n_density
    lanes = np.arange(L) < np.array(featlen)[:, None, None]   # [F, 1, L]
    spec.means = np.where(lanes, rng.standard_normal((1, F, D, L)),
                          0).astype(np.float32)
    spec.var = np.where(lanes, rng.uniform(0.3, 2.0, (1, F, D, L)),
                        0).astype(np.float32)
    spec.featlen = featlen
    spec.feat_params = (FEAT_PARAMS.replace("-feat 1s_c_d_dd\n",
                                            "-feat s2_4x\n")
                        .replace("-svspec 0-12/13-25/26-38\n", "")
                        .replace("-model ptm\n", "-model semi\n"))
    return spec


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


def bursts_pcm(seed: int, seconds: float, samprate: int = 16000,
               level: float = 4000.0) -> np.ndarray:
    """Seeded int16 PCM for the VAD and the `live` command: loud voiced
    bursts (0.5-1.2 s of harmonic tones with gliding pitch at `level`,
    over noise) between gaps of 0.7-1.2 s, the gaps in turn digital
    silence and quiet noise, after a quiet lead-in."""
    rng = np.random.default_rng(seed)
    n = int(seconds * samprate)
    x = np.zeros(n)
    pos = int(rng.uniform(0.3, 0.6) * samprate)
    x[:pos] = rng.normal(0.0, 20.0, pos)
    quiet = False
    while pos < n:
        end = min(pos + int(rng.uniform(0.5, 1.2) * samprate), n)
        tt = np.arange(end - pos) / samprate
        f0 = rng.uniform(100, 220) * (1 + 0.15 * np.sin(
            2 * np.pi * tt * rng.uniform(1, 3)))
        phase = 2 * np.pi * np.cumsum(f0) / samprate
        env = np.minimum(1.0, np.minimum(tt, tt[-1] - tt) / 0.02)
        voiced = sum(np.sin(k * phase) / k for k in range(1, 11))
        x[pos:end] = level * env * voiced + rng.normal(0.0, 200.0, end - pos)
        pos = min(end + int(rng.uniform(0.7, 1.2) * samprate), n)
        if quiet:
            x[end:pos] = rng.normal(0.0, 20.0, pos - end)
        quiet = not quiet
    return np.clip(x, -32768, 32767).astype(np.int16)


def write_arpa(words, path: str, seed: int = 0, p_bigram: float = 0.3,
               p_context: float = 0.2, max_tri: int = 4, order: int = 3):
    """A seeded ARPA trigram LM over `words` (+ <s>, </s>): random
    unigram scores, a `p_bigram` share of explicit successors per
    history, and explicit trigrams for a `p_context` share of the
    bigram contexts (none with `order=2`, a bigram LM).  Returns
    `path`."""
    rng = np.random.default_rng(seed)
    vocab = ["<s>", "</s>"] + [w for w in dict.fromkeys(words)
                                if w not in ("<s>", "</s>")]
    f = lambda x: f"{x:.4f}"  # noqa: E731
    uni = [(f(-99.0 if w == "<s>" else rng.uniform(-4, -1)), w,
            f(rng.uniform(-1, 0))) for w in vocab]
    succ = [w for w in vocab if w != "<s>"]
    big = []
    for h in vocab:
        if h == "</s>":
            continue
        for w in succ:
            if rng.random() < p_bigram:
                big.append((h, w))
    tri = []
    for h1, h2 in big if order >= 3 else ():
        if h2 != "</s>" and rng.random() < p_context:
            for w in rng.choice(succ, size=rng.integers(1, max_tri + 1),
                                replace=False):
                tri.append((h1, h2, str(w)))
    with open(path, "w") as out:
        out.write(f"\\data\\\nngram 1={len(uni)}\nngram 2={len(big)}\n"
                  + (f"ngram 3={len(tri)}\n" if order >= 3 else "")
                  + "\n\\1-grams:\n")
        for p_, w, bo in uni:
            out.write(f"{p_} {w} {bo}\n")
        out.write("\n\\2-grams:\n")
        for h, w in big:
            out.write(f"{f(rng.uniform(-3, -0.2))} {h} {w} "
                      f"{f(rng.uniform(-1, 0))}\n")
        if order >= 3:
            out.write("\n\\3-grams:\n")
            for h1, h2, w in tri:
                out.write(f"{f(rng.uniform(-2, -0.1))} {h1} {h2} {w}\n")
        out.write("\n\\end\\\n")
    return path


def small_dictionary(path: str, n_words: int = 40, n_single: int = 3,
                     seed: int = 0, n_extra_phones: int = 0) -> list[str]:
    """Write a dictionary of `n_words` seeded picks of bench-1.7k.dic plus
    its first `n_single` single-phone words; returns the words.  With
    `n_extra_phones` (for `make_model(n_extra_phones=...)`), extra phone i
    takes the place of a seeded phone of the i-th multi-phone pick (cycling
    over them): the last phone for even i, another for odd i, so that the
    extra phones end words and start and continue them."""
    lines = (BENCH_DATA / "bench-1.7k.dic").read_text().splitlines()
    rng = np.random.default_rng(seed)
    pick = [lines[i] for i in sorted(rng.choice(len(lines), n_words,
                                                replace=False))]
    multi = [i for i, ln in enumerate(pick) if len(ln.split()) > 2]
    for i, x in enumerate(extra_phones(n_extra_phones)):
        parts = pick[multi[i % len(multi)]].split()
        j = len(parts) - 1 if i % 2 == 0 else int(rng.integers(1, len(parts)
                                                                - 1))
        parts[j] = x
        pick[multi[i % len(multi)]] = " ".join(parts)
    pick += [ln for ln in lines if len(ln.split()) == 2][:n_single]
    with open(path, "w") as f:
        f.write("\n".join(pick) + "\n")
    return [ln.split()[0] for ln in pick]


def dictionary_for_lm(lm_path: str, base_dic: str, out: str,
                      seed: int = 0) -> str:
    """Write a dictionary with one pronunciation for every word of the LM
    at `lm_path` (the sentence markers excepted, which the noise
    dictionary holds): a word of `base_dic` keeps its own (first)
    pronunciation; every other word takes that of a seeded-random
    `base_dic` word, whose homophone it becomes.  The pronunciation
    lengths and the triphone set stay those of `base_dic`, so
    `make_model([out])` covers the same triphones as
    `make_model([base_dic])`.  Returns `out`."""
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


def build_decoder(spec: SynthModel, workdir: str, dic: str, lmfile: str,
                  lw: float = 6.5, wip: float = 0.65, **kw):
    """The port's `NgramFusedDecoder` over the synthetic model (files
    written under `workdir`), dictionary `dic` and LM file (keyword
    arguments go to the decoder)."""
    am, noise = spec.load(os.path.join(workdir, "model"))
    d2p = Dict2Pid(am.mdef, Dictionary(am.mdef, dic, noise))
    return NgramFusedDecoder(am, d2p, read_lm(lmfile, lw=lw, wip=wip), **kw)


def small_task(directory: str, n_words: int = 40, seed: int = 0,
               n_sen: int = 126 + 300, n_density: int = 8, n_state: int = 3):
    """A small decoding task under `directory`: a dictionary of
    `n_words` bench-1.7k words (plus 3 single-phone words), a seeded ARPA
    trigram LM over them and a synthetic model directory covering them
    (`n_state` emitting states per phone).  Returns (hmm directory,
    dictionary path, LM path)."""
    os.makedirs(directory, exist_ok=True)
    dic = os.path.join(directory, "small.dic")
    words = small_dictionary(dic, n_words=n_words, n_single=3, seed=seed)
    lmf = write_arpa(words, os.path.join(directory, "small.arpa"),
                     seed=seed + 1)
    spec = make_model([dic], seed=seed + 2, n_sen=n_sen, n_density=n_density,
                      n_state=n_state)
    hmm = spec.write_model_dir(os.path.join(directory, "hmm"))
    return hmm, dic, lmf


def grammar_words(dict_path: str) -> list[str]:
    """The distinct base words of a dictionary that a JSGF grammar can
    spell as plain tokens, in file order."""
    words = []
    for line in open(dict_path, encoding="utf-8", errors="replace"):
        parts = line.split()
        if parts and "(" not in parts[0] and not any(
                c in parts[0] for c in "=;|()[]*+{}/<>#"):
            words.append(parts[0])
    return list(dict.fromkeys(words))


def write_jsgf(dict_path: str, path: str, seed: int = 0,
               sizes=(200, 1000, 100)) -> str:
    """A seeded command grammar, `public <cmd> = <verb> <object> [<mod>];`,
    whose three rules are alternations of `sizes` distinct words of the
    dictionary.  Returns `path`."""
    rng = np.random.default_rng(seed)
    words = grammar_words(dict_path)
    pick = [words[i] for i in rng.choice(len(words), sum(sizes),
                                         replace=False)]
    rules, at = [], 0
    for name, n in zip(("verb", "object", "mod"), sizes):
        rules.append(f"<{name}> = " + " | ".join(pick[at:at + n]) + ";")
        at += n
    with open(path, "w") as f:
        f.write("#JSGF V1.0;\ngrammar synth;\n"
                "public <cmd> = <verb> <object> [<mod>];\n"
                + "\n".join(rules) + "\n")
    return path


def write_keyphrases(dict_path: str, path: str, seed: int = 0, n: int = 20,
                     max_words: int = 3) -> str:
    """A seeded -kws list: `n` phrases of 1..`max_words` dictionary words,
    each with its own /threshold/.  Returns `path`."""
    rng = np.random.default_rng(seed)
    words = grammar_words(dict_path)
    with open(path, "w") as f:
        for _ in range(n):
            k = int(rng.integers(1, max_words + 1))
            phrase = " ".join(words[i] for i in rng.choice(len(words), k))
            f.write(f"{phrase} /1e-{int(rng.integers(20, 300))}/\n")
    return path


def write_phone_arpa(path: str, seed: int = 0) -> str:
    """A seeded phone-bigram ARPA LM over the 42 CI phone names (the
    allphone search's LM).  Returns `path`."""
    return write_arpa(PHONES + [SIL, *FILLERS], path, seed=seed,
                      p_bigram=0.5, order=2)
