#!/usr/bin/env python3
"""Corpus decoding in padded batches through the PyTorch port (the
counterpart of batch_tpu.py): the flat n-gram search (`NgramFlatDecoder`,
its scan a captured CUDA graph on the card) behind `BatchDecodePipeline`
with the denoising batched frontend (its noise removal a CUDA kernel on
the card), over a mesh of every visible card (one replica each).
Decodes eight copies of one recording and prints each hypothesis, as
batch_tpu.py does.

    python examples/torch_batch.py [--device cpu] [-hmm DIR] [-lm LM]
                                   [-dict DIC] [AUDIO]

The model, LM, dictionary and raw 16 kHz audio default to batch_tpu.py's
files under $PS_REFERENCE (model/en-us/en-us with its noisedict,
test/data/turtle.lm.bin, test/data/turtle.dic,
test/data/goforward.raw).  Runs on the card unless given --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pocketsphinx_tpu_torch import resolve_device
from pocketsphinx_tpu_torch.fileio.dictionary import Dictionary
from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
from pocketsphinx_tpu_torch.lm.ngram import read_lm
from pocketsphinx_tpu_torch.models.acoustic import AcousticModel
from pocketsphinx_tpu_torch.models.dict2pid import Dict2Pid
from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
from pocketsphinx_tpu_torch.search.ngram_flat import NgramFlatDecoder


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
    device = resolve_device(a.device)
    hmm = reference(a.hmm, "model/en-us/en-us")
    am = AcousticModel.load(hmm)
    d = Dictionary(am.mdef, reference(a.dict, "test/data/turtle.dic"),
                   os.path.join(hmm, "noisedict"))
    lm = read_lm(reference(a.lm, "test/data/turtle.lm.bin"), lw=6.5,
                 wip=0.65)
    dec = NgramFlatDecoder(am, Dict2Pid(am.mdef, d), lm, device=device)
    fe = MelFrontend(nfilt=25, lowerf=130, upperf=6800, transform="dct",
                     lifter_val=22, remove_noise=True)
    pipe = BatchDecodePipeline(dec, fe, mesh=make_mesh(device=device))
    with open(reference(a.audio, "test/data/goforward.raw"), "rb") as f:
        pcm = np.frombuffer(f.read(), dtype="<i2")
    for hyp, segs in pipe.decode_corpus([pcm] * 8):
        print(hyp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
