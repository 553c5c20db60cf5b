#!/usr/bin/env python3
"""Endpointer-segmented decoding of a long recording through the PyTorch
port (the counterpart of live.py): the WebRTC-VAD endpointer cuts the
recording into utterances, and each one streams through
`Decoder.process_raw`; prints each one's span and hypothesis as live.py
does.

    python examples/torch_live.py [--device cpu] [-hmm DIR] [-lm LM]
                                  [-dict DIC] [AUDIO]

The model, LM and dictionary default to live.py's under $PS_REFERENCE
(model/en-us/en-us, test/data/turtle.lm.bin, test/data/turtle.dic), the
recording (WAV, NIST or raw) to test/data/goforward.raw there.  Runs on
the card unless given --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pocketsphinx_tpu_torch import Decoder
from pocketsphinx_tpu_torch.fileio.sound import read_audio
from pocketsphinx_tpu_torch.vad.endpointer import Endpointer


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
    pcm, rate = read_audio(reference(a.audio, "test/data/goforward.raw"))
    ep = Endpointer(sample_rate=rate)
    for start, end, speech in ep.segment(pcm):
        d.start_utt()
        d.process_raw(speech)
        d.end_utt()
        print(f"[{start:.2f}-{end:.2f}] {d.hyp().hypstr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
