"""`pocketsphinx-tpu-torch-batch` — corpus batch decoding
(programs/pocketsphinx_batch.c re-design).

Port of `pocketsphinx_tpu.cli_batch`.  Control-file driven: -ctl lists
utterance ids; inputs are audio (-adcin yes, -cepdir/-cepext) or MFCC
files; hypotheses go to -hyp as "words (uttid)" lines and segmentations
to -hypseg.  -ctloffset/-ctlcount resume a partial run; -mllrctl names
one MLLR transform per -ctl line, consecutive equal names forming one
speaker group; -outlatdir writes each utterance's lattice.

Unlike the reference's one-utterance-at-a-time loop, utterances are
decoded in device batches of -batchsize: features are computed on the
host as the `Decoder` computes them, padded per batch, and scored,
scanned and backtraced on the decoder's device (CUDA unless `main` is
passed `device="cpu"`).
"""

from __future__ import annotations

import sys

import numpy as np

from .config import Config, PARAMS
from .decoder import Decoder
from .fileio.mfc import read_mfc
from .fileio.sound import read_audio
from .frontend.feat import compute_feats_typed

BATCH_PARAMS = {
    "ctl": (str, None, "Control file listing utterances to be processed"),
    "ctloffset": (int, 0, "No. of utterances at the beginning of -ctl file to be skipped"),
    "ctlcount": (int, -1, "No. of utterances to be processed (after skipping -ctloffset entries)"),
    "cepdir": (str, None, "Input files directory (prefixed to filespecs in control file)"),
    "cepext": (str, ".mfc", "Input files extension (suffixed to filespecs in control file)"),
    "adcin": (bool, False, "Input is raw audio data"),
    "adchdr": (int, 0, "Size of audio file header in bytes (headers are ignored)"),
    "hyp": (str, None, "Recognition output file name"),
    "hypseg": (str, None, "Recognition output with segmentation file name"),
    "outlatdir": (str, None, "Directory for dumping word lattices"),
    "batchsize": (int, 16, "Device batch size for batched decoding"),
    "mllrctl": (str, None, "Control file listing MLLR file to use for each utterance"),
    "mllrdir": (str, None, "Base directory for MLLR files"),
    "mllrext": (str, None, "File extension for MLLR files"),
}

PARAMS.update(BATCH_PARAMS)


def read_utt(config: Config, uttid: str):
    """("pcm", int16 samples) or ("cep", MFCC [T, ceplen]) of one
    utterance."""
    path = uttid
    if config["cepdir"]:
        path = f"{config['cepdir']}/{uttid}"
    path = path + (config["cepext"] or "")
    if config["adcin"]:
        pcm, rate = read_audio(path, config["samprate"])
        hdr = config["adchdr"]
        if hdr:
            pcm = pcm[hdr // 2:]
        return ("pcm", pcm)
    return ("cep", read_mfc(path, config["ceplen"]))


def main(argv=None, device=None):
    try:
        return _main(argv, device)
    except (FileNotFoundError, KeyError, ValueError, RuntimeError) as e:
        sys.stderr.write(f"ERROR: {e}\n")
        return 1


def _main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config = Config()
    try:
        config.parse_argv(argv)
    except (KeyError, ValueError) as e:
        sys.stderr.write(f"ERROR: {e}\n")
        return 1
    if not config["ctl"]:
        sys.stderr.write("ERROR: -ctl is required\n")
        return 1
    dec = Decoder(config, device=device)
    utts = [l.strip().split()[0] for l in open(config["ctl"])
            if l.strip()]
    mllr_names = None
    if config["mllrctl"]:
        mllr_names = [l.strip() for l in open(config["mllrctl"])
                      if l.strip()]
        if len(mllr_names) != len(utts):
            sys.stderr.write("ERROR: File size mismatch between control "
                             "and MLLR control\n")
            return 1
    off = config["ctloffset"]
    cnt = config["ctlcount"]
    utts = utts[off:off + cnt] if cnt >= 0 else utts[off:]
    if mllr_names is not None:
        mllr_names = (mllr_names[off:off + cnt] if cnt >= 0
                      else mllr_names[off:])

    search = dec._searches.get(dec._active)
    can_batch = hasattr(search, "decode_batch")
    feats_list = []
    for uttid in utts:
        kind, data = read_utt(config, uttid)
        cep = dec.fe.process(data) if kind == "pcm" else data
        feats, _ = compute_feats_typed(
            cep, feat_type=config["feat"], svspec=config["svspec"],
            cmn=config["cmn"], cmn_state=dec.cmn_state,
            agc=config["agc"], varnorm=config["varnorm"])
        feats_list.append(feats)

    results = [None] * len(utts)
    records = [None] * len(utts)    # per-utterance records (for lattices)
    # hyp-only runs (no -outlatdir) keep the top-K-compressed records
    kw = {}
    if not config["outlatdir"] and hasattr(search, "backtrace_min"):
        kw = {"keep_records": False}

    def decode_group(members):
        if can_batch and len(members) > 1:
            B = config["batchsize"]
            order = sorted(members, key=lambda i: len(feats_list[i]))
            for i0 in range(0, len(order), B):
                idx = order[i0:i0 + B]
                Tmax = max(len(feats_list[i]) for i in idx)
                shape = feats_list[idx[0]].shape[1:]
                fb = np.zeros((len(idx), Tmax) + shape, np.float32)
                nf = np.zeros(len(idx), np.int32)
                for k, i in enumerate(idx):
                    fb[k, :len(feats_list[i])] = feats_list[i]
                    nf[k] = len(feats_list[i])
                out = search.decode_batch(fb, nf, **kw)
                for k, i in enumerate(idx):
                    results[i] = out[k]
                    records[i] = (search.batch_records[k]
                                  if search.batch_records is not None
                                  else None)
        else:
            for i in members:
                results[i] = search.decode(feats_list[i])
                records[i] = (getattr(search, "records", None)
                              if config["outlatdir"] else None)

    if mllr_names is None:
        decode_group(list(range(len(utts))))
    else:
        g0 = 0
        while g0 < len(utts):
            g1 = g0
            while g1 < len(utts) and mllr_names[g1] == mllr_names[g0]:
                g1 += 1
            name = mllr_names[g0]
            path = name
            if config["mllrdir"]:
                path = f"{config['mllrdir']}/{name}"
            if config["mllrext"]:
                path = path + config["mllrext"]
            dec.update_mllr(path)
            sys.stderr.write(f"INFO: Using MLLR: {name}\n")
            decode_group(list(range(g0, g1)))
            g0 = g1

    hyp_f = open(config["hyp"], "w") if config["hyp"] else sys.stdout
    hypseg_f = open(config["hypseg"], "w") if config["hypseg"] else None
    outlatdir = config["outlatdir"]
    for uttid, (hyp, segs), recs in zip(utts, results, records):
        hyp_f.write(f"{hyp} ({uttid})\n")
        if outlatdir and recs is not None:
            from .search.lattice import Lattice
            try:
                lat = Lattice.from_flat_records(search, records=recs)
                lat.write(f"{outlatdir}/{uttid}.lat")
            except Exception as e:
                sys.stderr.write(f"WARNING: lattice for {uttid}: {e}\n")
        if hypseg_f is not None:
            parts = [f"{s.word} {s.start} {s.end}" for s in segs]
            hypseg_f.write(f"{uttid} " + " ".join(parts) + "\n")
    if config["hyp"]:
        hyp_f.close()
    if hypseg_f:
        hypseg_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
