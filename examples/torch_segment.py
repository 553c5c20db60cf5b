#!/usr/bin/env python3
"""VAD segmentation without decoding, through the PyTorch port (the
counterpart of segment.py): prints each speech segment the WebRTC-VAD
endpointer finds, as segment.py does.

    python examples/torch_segment.py AUDIO

The VAD and the endpointer are host integer code in both packages, so
this example uses no device.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pocketsphinx_tpu_torch.fileio.sound import read_audio
from pocketsphinx_tpu_torch.vad.endpointer import Endpointer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("audio", help="a WAV, NIST or raw 16 kHz recording")
    a = ap.parse_args(argv)
    pcm, rate = read_audio(a.audio)
    ep = Endpointer(sample_rate=rate)
    for i, (start, end, speech) in enumerate(ep.segment(pcm)):
        print(f"segment {i}: {start:.2f}-{end:.2f} "
              f"({len(speech)/rate:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
