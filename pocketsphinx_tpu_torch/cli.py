"""The `pocketsphinx-tpu-torch` command-line program
(programs/pocketsphinx_main.c re-design): commands live | single | align |
config | soxflags | help, line-JSON output with the reference's field
names (b/d/p/t/w = begin/duration/posterior/text/words,
programs/pocketsphinx_main.c:85-154).

Port of `pocketsphinx_tpu.cli`: the same commands and output, over the
port's `Decoder` on CUDA unless `main` is passed `device="cpu"`.  `live`
segments files (or stdin) with the port's WebRTC VAD endpointer and
decodes each segment by streaming it through `process_raw`."""

from __future__ import annotations

import json
import sys

import numpy as np

from .config import Config
from .decoder import Decoder
from .fileio.sound import read_audio
from .vad.endpointer import Endpointer

USAGE = """\
Usage: pocketsphinx-tpu-torch [OPTIONS] COMMAND [ARGS]...

Commands:
  help              Print this help
  config            Dump configuration as JSON
  live [INPUTS]     Segment and recognize speech (VAD-segmented)
  single INPUT      Recognize INPUT as a single utterance
  align INPUT TEXT  Align INPUT to TEXT
  soxflags          Print sox(1) flags for the current configuration
"""


def _split_args(argv):
    """Options (-key value) come first; the first non-option token is the
    command (matching the reference CLI's argument order)."""
    opts = []
    i = 0
    while i < len(argv):
        if argv[i].startswith("-") and not argv[i].lstrip("-").isdigit() \
                and len(argv[i]) > 1:
            opts.extend(argv[i:i + 2])
            i += 2
        else:
            break
    return opts, argv[i:]


def format_seg(seg):
    return {"b": round(seg.start, 3), "d": round(seg.duration, 3),
            "p": round(seg.prob, 3), "t": seg.word}


def output_backtrace(decoder, stream=None):
    """-backtrace: reference-format per-word result table + xRT lines
    (src/pocketsphinx.c:1341-1367, src/ngram_search.c:866-871) on
    `stream` (default stderr)."""
    stream = stream or sys.stderr
    hyp = decoder.hyp()
    if hyp is None:
        return
    stream.write(f"INFO: {hyp.hypstr} ({int(hyp.score)})\n")
    stream.write(f"INFO: {'word':<20} {'start':<5} {'end':<5} "
                 f"{'pprob':<5} {'ascr':<10} {'lscr':<10} {'lback':<3}\n")
    for s in decoder.seg_iter():
        stream.write(
            f"INFO: {s.word:<20} {s.start_frame:<5d} {s.end_frame:<5d} "
            f"{s.prob:<1.3f} {int(s.ascore):<10d} {int(s.lscore):<10d} "
            f"{1:<3d}\n")
    ns, cpu, wall = decoder.get_utt_time()
    if ns > 0:
        stream.write(f"INFO: decode {cpu:.2f} CPU {cpu / ns:.3f} xRT\n")
        stream.write(f"INFO: decode {wall:.2f} wall "
                     f"{wall / ns:.3f} xRT\n")


def output_total_xrt(decoder, stream=None):
    """TOTAL xRT summary like the per-search free() logs
    (e.g. src/fsg_search.c:267-271), on `stream` (default stderr)."""
    stream = stream or sys.stderr
    ns, cpu, wall = decoder.get_all_time()
    if ns > 0:
        stream.write(f"INFO: TOTAL decode {cpu:.2f} CPU "
                     f"{cpu / ns:.3f} xRT\n")
        stream.write(f"INFO: TOTAL decode {wall:.2f} wall "
                     f"{wall / ns:.3f} xRT\n")


def hyp_doc(decoder) -> dict:
    """The `single` command's JSON object of the decoder's last result."""
    hyp = decoder.hyp()
    segs = list(decoder.seg_iter())
    b = segs[0].start if segs else 0.0
    d = (segs[-1].start + segs[-1].duration - b) if segs else 0.0
    return {"b": round(b, 3), "d": round(d, 3),
            "p": round(hyp.prob, 3) if hyp else 1.0,
            "t": hyp.hypstr if hyp else "",
            "w": [format_seg(s) for s in segs]}


def segment_doc(decoder, start: float, end: float) -> dict:
    """The `live` command's JSON object of one VAD segment [start, end)
    seconds, decoded last: word times are offset by `start`."""
    return {"b": round(start, 3), "d": round(end - start, 3),
            "p": 1.0, "t": decoder.hyp().hypstr,
            "w": [dict(format_seg(s), b=round(s.start + start, 3))
                  for s in decoder.seg_iter()]}


def output_hyp(decoder, stream=None):
    stream = stream or sys.stdout
    stream.write(json.dumps(hyp_doc(decoder)) + "\n")
    stream.flush()


def output_align(decoder, phone_align, state_align, stream=None):
    stream = stream or sys.stdout
    words, phones, states = decoder.get_alignment()
    frate = decoder.fe.frate

    def ent(e):
        return {"b": round(e.start / frate, 3),
                "d": round(e.duration / frate, 3),
                "p": 1.0, "t": e.text}
    wdocs = []
    for wi, w in enumerate(words):
        doc = ent(w)
        if phone_align:
            pdocs = []
            for k, p in enumerate(phones):
                if p.parent != wi:
                    continue
                pd = ent(p)
                if state_align:
                    pd["w"] = [dict(ent(s), t=str(s.senid))
                               for s in states if s.parent == k]
                pdocs.append(pd)
            doc["w"] = pdocs
        wdocs.append(doc)
    hyp = decoder.hyp()
    total_b = words[0].start / frate if words else 0.0
    total_d = ((words[-1].start + words[-1].duration) / frate - total_b
               if words else 0.0)
    doc = {"b": round(total_b, 3), "d": round(total_d, 3), "p": 1.0,
           "t": hyp.hypstr if hyp else "", "w": wdocs}
    stream.write(json.dumps(doc) + "\n")
    stream.flush()


def main(argv=None, device=None):
    """Run one command; returns the exit code.  Decoding commands build a
    `Decoder` on `device` (CUDA unless given; an error naming CUDA and
    exit code 1 when it is absent)."""
    try:
        return _main(argv, device)
    except (FileNotFoundError, KeyError, ValueError, RuntimeError) as e:
        sys.stderr.write(f"ERROR: {e}\n")
        return 1


def _main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, rest = _split_args(argv)
    if not rest:
        sys.stderr.write(USAGE)
        return 1
    command, args = rest[0], rest[1:]
    config = Config()
    try:
        config.parse_argv(opts)
    except (KeyError, ValueError) as e:
        sys.stderr.write(f"ERROR: {e}\n")
        return 1

    if command == "help":
        sys.stderr.write(USAGE)
        return 0
    if command == "config":
        config.default_search_args()
        config.expand_model_config()
        sys.stdout.write(config.serialize_json() + "\n")
        return 0
    if command == "soxflags":
        config.default_search_args()
        # Matches the reference: raw 16-bit mono at the config samprate
        sr = config["samprate"]
        sys.stdout.write(f"-r {sr} -c 1 -b 16 -e signed-integer -t raw -\n")
        return 0

    if command == "single":
        if not args:
            sys.stderr.write("single requires an input file\n")
            return 1
        dec = Decoder(config, device=device)
        pcm, rate = read_audio(args[0], config["samprate"])
        if rate != config["samprate"]:
            sys.stderr.write(f"WARNING: sample rate {rate} != configured "
                             f"{config['samprate']}\n")
        hyp = dec.decode_raw(pcm)
        if hyp is None:
            sys.stderr.write(f"Recognition failed on {args[0]}\n")
            return 1
        if config["backtrace"]:
            output_backtrace(dec)
        output_hyp(dec)
        if config["loglevel"] in ("INFO", "DEBUG"):
            output_total_xrt(dec)
        return 0

    if command == "align":
        if len(args) < 2:
            sys.stderr.write("align requires an input file and text\n")
            return 1
        if config.validate_search_mode() is not None:
            sys.stderr.write("align command does not accept search modes\n")
            return 1
        dec = Decoder(config, device=device)
        dec.add_align_text(" ".join(args[1:]))
        pcm, rate = read_audio(args[0], config["samprate"])
        hyp = dec.decode_raw(pcm)
        if hyp is None:
            sys.stderr.write(f"Alignment failed on {args[0]}\n")
            return 1
        output_align(dec, phone_align=config["phone_align"]
                     or config["state_align"],
                     state_align=config["state_align"])
        return 0

    if command == "live":
        dec = Decoder(config, device=device)
        ep = Endpointer(sample_rate=config["samprate"])
        for fn in args or ["-"]:
            if fn == "-":
                pcm = np.frombuffer(sys.stdin.buffer.read(), dtype="<i2")
            else:
                pcm, _ = read_audio(fn, config["samprate"])
            for (start, end, speech) in ep.segment(pcm):
                dec.start_utt()
                dec.process_raw(speech)
                dec.end_utt()
                if dec.hyp() is not None:
                    sys.stdout.write(json.dumps(segment_doc(dec, start, end))
                                     + "\n")
                    sys.stdout.flush()
        return 0

    sys.stderr.write(f"Unknown command {command!r}\n{USAGE}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
