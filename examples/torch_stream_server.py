#!/usr/bin/env python3
"""Streaming recognition server through the PyTorch port (the counterpart
of stream_server.py, itself the reference's GStreamer element,
gst/gstpocketsphinx.c).

16-bit/16 kHz mono PCM in (stdin or a TCP socket), newline-delimited JSON
events out, with stream_server.py's keys and rounding:

  {"event": "start",   "t": <stream-time-s>}
  {"event": "partial", "t": ..., "hyp": "..."}          (mid-utterance)
  {"event": "final",   "b": ..., "d": ..., "t": "...", "w": [...]}

driven by the port's WebRTC-VAD endpointer (vad/endpointer.py) and its
`Decoder`: the n-gram search streams each utterance through
`process_raw` with partial hypotheses; a grammar (-jsgf, -fsg), keyword
(-kws, -keyphrase) or phone (-allphone) search decodes the utterance at
its end, as the JAX package's do, each through its captured CUDA graph
on the card.

Usage:
  python examples/torch_stream_server.py --stdio  < audio.raw
  python examples/torch_stream_server.py --listen 127.0.0.1:7350
  # then:  sox mic.wav -t raw -r 16000 -e signed -b 16 - | nc 127.0.0.1 7350

Options: -hmm/-lm/-dict and any decoder setting as its usual flag (each
into the port's `Config`), --partial-every N (VAD frames between partial
events, default 30 = 0.3 s), --device cpu (default: the card).
"""

import argparse
import json
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pocketsphinx_tpu_torch.config import Config
from pocketsphinx_tpu_torch.decoder import Decoder
from pocketsphinx_tpu_torch.vad.endpointer import Endpointer


def serve(read_fn, write_fn, config, partial_every=30, device=None,
          decoder=None):
    """Serve one PCM stream: `read_fn(n)` gives up to n bytes (b"" at its
    end), `write_fn(bytes)` takes each event's JSON line.  `decoder`: a
    `Decoder` built from `config` to serve with (default: one built here
    on `device`)."""
    dec = decoder if decoder is not None else Decoder(config, device=device)
    ep = Endpointer(sample_rate=config["samprate"])
    frame_len = ep.frame_size              # samples per VAD frame
    buf = np.zeros(0, np.int16)
    stream_t = 0.0
    in_speech = False
    utt_start = 0.0
    frames_since_partial = 0
    frame_s = frame_len / float(config["samprate"])

    def emit(doc):
        write_fn((json.dumps(doc) + "\n").encode())

    def finish():
        nonlocal in_speech, frames_since_partial
        dec.end_utt()
        h = dec.hyp()
        if h is not None and h.hypstr:
            segs = [
                {"w": s.word, "b": round(utt_start + s.start, 3),
                 "d": round(s.duration, 3)}
                for s in dec.seg_iter()]
            emit({"event": "final", "b": round(utt_start, 3),
                  "d": round(stream_t - utt_start, 3), "t": h.hypstr,
                  "w": segs})
        in_speech = False
        frames_since_partial = 0

    while True:
        data = read_fn(2 * frame_len)
        if not data:
            break
        buf = np.concatenate([buf, np.frombuffer(data, dtype="<i2")])
        while len(buf) >= frame_len:
            frame = buf[:frame_len]
            buf = buf[frame_len:]
            prev = in_speech
            speech_frame = ep.process(frame)
            now_speech = ep.in_speech
            if now_speech and not prev:
                utt_start = stream_t
                dec.start_utt()
                emit({"event": "start", "t": round(stream_t, 3)})
                in_speech = True
            # the endpointer returns the final speech frame with in_speech
            # already False: it still belongs to the utterance
            if speech_frame is not None and (now_speech or prev):
                dec.process_raw(speech_frame)
                frames_since_partial += 1
                if now_speech and frames_since_partial >= partial_every:
                    frames_since_partial = 0
                    h = dec.partial_hyp()
                    if h is not None and h.hypstr:
                        emit({"event": "partial",
                              "t": round(stream_t, 3),
                              "hyp": h.hypstr})
            if prev and not now_speech:
                finish()
            stream_t += frame_s
    if in_speech:
        tail = ep.end_stream()
        if tail is not None and len(tail):
            dec.process_raw(tail)
        finish()


def parse_args(argv=None):
    """(the server's options, the decoder's `Config` from every other
    `-flag value` pair)."""
    # add_help=False + allow_abbrev=False so decoder flags like -hmm are
    # not taken as abbreviations of -h
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0], add_help=False,
        allow_abbrev=False)
    ap.add_argument("--help", action="help")
    ap.add_argument("--stdio", action="store_true")
    ap.add_argument("--listen", metavar="HOST:PORT")
    ap.add_argument("--partial-every", type=int, default=30)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(argv)
    cfg_kw = {}
    it = iter(rest)
    for tok in it:
        if tok.startswith("-"):
            cfg_kw[tok.lstrip("-")] = next(it, None)
    return args, Config(**cfg_kw)


def main(argv=None):
    args, config = parse_args(argv)
    if args.listen:
        host, port = args.listen.rsplit(":", 1)
        srv = socket.create_server((host, int(port)))
        sys.stderr.write(f"listening on {args.listen}\n")
        while True:
            conn, addr = srv.accept()
            sys.stderr.write(f"client {addr}\n")
            f = conn.makefile("rwb")
            try:
                serve(f.read, lambda b: (f.write(b), f.flush()),
                      config, args.partial_every, device=args.device)
            finally:
                f.close()
                conn.close()
    else:
        serve(sys.stdin.buffer.read,
              lambda b: (sys.stdout.buffer.write(b),
                         sys.stdout.buffer.flush()),
              config, args.partial_every, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
