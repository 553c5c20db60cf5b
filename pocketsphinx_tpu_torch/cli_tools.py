"""Auxiliary command-line tools, mirroring the reference's
pocketsphinx_lm_convert / _lm_eval / _jsgf2fsg / _mdef_convert / _pitch
programs.  Port of `pocketsphinx_tpu.cli_tools` (host code), installed as
`pocketsphinx-tpu-torch-{lm-convert,lm-eval,jsgf2fsg,mdef-convert,pitch}`."""

from __future__ import annotations

import math
import sys

import numpy as np


def lm_convert_main(argv=None):
    """LM format conversion (programs/pocketsphinx_lm_convert.c):
    -i input -o output [-ofmt arpa]."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(zip(argv[::2], argv[1::2]))
    inp, out = opts.get("-i"), opts.get("-o")
    ofmt = opts.get("-ofmt", "arpa")
    if not inp or not out:
        sys.stderr.write("Usage: pocketsphinx-tpu-torch-lm-convert -i IN "
                         "-o OUT [-ofmt arpa|bin|dmp]\n")
        return 1
    from .lm.ngram import read_lm, write_arpa, write_trie_bin, write_dmp
    m = read_lm(inp)
    if ofmt in ("arpa", "txt"):
        write_arpa(m, out)
    elif ofmt in ("bin", "trie"):
        write_trie_bin(m, out)
    elif ofmt == "dmp":
        write_dmp(m, out)
    else:
        sys.stderr.write(f"Output format {ofmt!r} not supported "
                         "(arpa | bin | dmp)\n")
        return 1
    return 0


def mdef_convert_main(argv=None):
    """Model-definition conversion (programs/pocketsphinx_mdef_convert.c):
    [-text | -bin] INPUT OUTPUT."""
    argv = list(sys.argv[1:] if argv is None else argv)
    fmt = None
    if argv and argv[0] in ("-text", "-bin"):
        fmt = argv.pop(0)[1:]
    if len(argv) != 2:
        sys.stderr.write("Usage: pocketsphinx-tpu-torch-mdef-convert "
                         "[-text | -bin] INPUT OUTPUT\n")
        return 1
    inp, out = argv
    if fmt is None:
        fmt = "text" if out.endswith((".txt", ".text")) else "bin"
    from .fileio.bin_mdef import (read_bin_mdef, write_bin_mdef,
                                  write_text_mdef)
    try:
        m = read_bin_mdef(inp)   # auto-detects text vs binary input
    except Exception as e:
        sys.stderr.write(f"ERROR: cannot read mdef {inp!r}: {e}\n")
        return 1
    if fmt == "text":
        write_text_mdef(m, out)
    else:
        write_bin_mdef(m, out)
    return 0


def lm_eval_main(argv=None):
    """Perplexity evaluation (programs/pocketsphinx_lm_eval.c):
    -lm FILE -text 'sentence' or -ctl file-of-sentences."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(zip(argv[::2], argv[1::2]))
    lm_path = opts.get("-lm")
    if not lm_path:
        sys.stderr.write("Usage: pocketsphinx-tpu-torch-lm-eval -lm FILE "
                         "(-text 'words' | -ctl FILE)\n")
        return 1
    from .lm.ngram import read_lm, LN_BASE
    m = read_lm(lm_path)
    sentences = []
    if opts.get("-text"):
        sentences.append(opts["-text"].split())
    if opts.get("-ctl"):
        with open(opts["-ctl"]) as f:
            sentences += [l.split() for l in f if l.strip()]
    total, n = 0.0, 0
    for words in sentences:
        t, k = m.sentence_score(words)
        total += t * LN_BASE  # -> nats
        n += k
    if n == 0:
        sys.stderr.write("No words evaluated\n")
        return 1
    ppl = math.exp(-total / n)
    print(f"perplexity: {ppl:.4f} (over {n} words)")
    return 0


def jsgf2fsg_main(argv=None):
    """JSGF -> FSG conversion (programs/pocketsphinx_jsgf2fsg.c):
    -jsgf IN [-fsg OUT] [-toprule RULE]."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(zip(argv[::2], argv[1::2]))
    inp = opts.get("-jsgf")
    if not inp:
        sys.stderr.write("Usage: pocketsphinx-tpu-torch-jsgf2fsg -jsgf IN "
                         "[-fsg OUT] [-toprule RULE]\n")
        return 1
    from .lm.jsgf import Jsgf
    fsg = Jsgf.parse_file(inp).build_fsg(opts.get("-toprule"))
    out = opts.get("-fsg")
    if out:
        fsg.writefile(out)
    else:
        import os
        import tempfile
        fd, tmp = tempfile.mkstemp()
        os.close(fd)
        try:
            fsg.writefile(tmp)
            with open(tmp) as f:
                sys.stdout.write(f.read())
        finally:
            os.unlink(tmp)
    return 0


def yin_pitch(pcm: np.ndarray, samprate: int = 16000,
              frame_shift: int = 160, frame_size: int = 410,
              fmin: float = 50.0, fmax: float = 500.0,
              threshold: float = 0.1) -> np.ndarray:
    """YIN F0 estimation (src/fe/yin.c re-design): difference function,
    cumulative-mean normalization, absolute threshold with parabolic
    interpolation.  Returns F0 per frame (0 = unvoiced)."""
    x = np.asarray(pcm, dtype=np.float64)
    tau_max = min(int(samprate / fmin), frame_size // 2)
    tau_min = max(2, int(samprate / fmax))
    n_frames = max(0, 1 + (len(x) - frame_size) // frame_shift)
    f0 = np.zeros(n_frames)
    W = frame_size // 2
    for i in range(n_frames):
        fr = x[i * frame_shift:i * frame_shift + frame_size]
        # difference function via autocorrelation identity
        d = np.zeros(tau_max)
        for tau in range(1, tau_max):
            diff = fr[:W] - fr[tau:tau + W]
            d[tau] = np.dot(diff, diff)
        cum = np.cumsum(d[1:])
        cmndf = np.ones(tau_max)
        cmndf[1:] = d[1:] * np.arange(1, tau_max) / np.maximum(cum, 1e-12)
        tau = -1
        for t in range(tau_min, tau_max):
            if cmndf[t] < threshold:
                while t + 1 < tau_max and cmndf[t + 1] < cmndf[t]:
                    t += 1
                tau = t
                break
        if tau < 0:
            t = int(np.argmin(cmndf[tau_min:tau_max])) + tau_min
            if cmndf[t] < 0.5:
                tau = t
        if tau > 0:
            # parabolic interpolation around tau
            if 1 <= tau < tau_max - 1:
                a, b, c = cmndf[tau - 1], cmndf[tau], cmndf[tau + 1]
                denom = 2 * (a - 2 * b + c)
                shift = (a - c) / denom if abs(denom) > 1e-12 else 0.0
                tau = tau + shift
            f0[i] = samprate / tau
    return f0


def pitch_main(argv=None):
    """F0 extraction (programs/pocketsphinx_pitch.c): -i IN [-o OUT]."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(zip(argv[::2], argv[1::2]))
    inp = opts.get("-i")
    if not inp:
        sys.stderr.write("Usage: pocketsphinx-tpu-torch-pitch -i IN "
                         "[-o OUT]\n")
        return 1
    from .fileio.sound import read_audio
    samprate = int(opts.get("-samprate", "16000"))
    pcm, rate = read_audio(inp, samprate)
    frate = int(opts.get("-frate", "100"))
    shift = rate // frate
    f0 = yin_pitch(pcm, rate, frame_shift=shift,
                   frame_size=int(0.025625 * rate))
    out = opts.get("-o")
    lines = "".join(f"{i / frate:.2f} {v:.2f}\n" for i, v in enumerate(f0))
    if out:
        with open(out, "w") as f:
            f.write(lines)
    else:
        sys.stdout.write(lines)
    return 0
