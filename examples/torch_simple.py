#!/usr/bin/env python3
"""Minimal decoding example through the PyTorch port (the counterpart of
simple.py): one recording through `Decoder.decode_raw`, then its
hypothesis and word segments, printed as simple.py prints them.

    python examples/torch_simple.py [--device cpu] [-hmm DIR] [-lm LM]
                                    [-dict DIC] [AUDIO]

The model, LM, dictionary and raw 16 kHz audio default to simple.py's
files under $PS_REFERENCE (model/en-us/en-us, test/data/turtle.lm.bin,
test/data/turtle.dic, test/data/goforward.raw).  Runs on the card unless
given --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pocketsphinx_tpu_torch import Decoder


def reference(flag, rel):
    """A flag's value, else `rel` under $PS_REFERENCE."""
    if flag:
        return flag
    ref = os.environ.get("PS_REFERENCE")
    if not ref:
        sys.exit(f"set PS_REFERENCE or pass the path of {rel}")
    return os.path.join(ref, rel)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("-hmm")
    ap.add_argument("-lm")
    ap.add_argument("-dict")
    ap.add_argument("audio", nargs="?")
    a = ap.parse_args(argv)
    d = Decoder(hmm=reference(a.hmm, "model/en-us/en-us"),
                lm=reference(a.lm, "test/data/turtle.lm.bin"),
                dict=reference(a.dict, "test/data/turtle.dic"),
                device=a.device)
    with open(reference(a.audio, "test/data/goforward.raw"), "rb") as f:
        hyp = d.decode_raw(f.read())
    print(hyp.hypstr)
    for seg in d.seg_iter():
        print(f"  {seg.word}\t{seg.start:.2f} +{seg.duration:.2f}\t"
              f"p={seg.prob:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
