"""Readers and writers for MFCC (.mfc) and senone-score (.sen) dump files.

A copy of `pocketsphinx_tpu.fileio.mfc`.

These are both debug/trace seams and test-fixture formats in the reference
(SURVEY.md §5.1): `-mfclogdir` / `-senlogdir` outputs and the classic
Sphinx big-endian .mfc corpus format.

Formats:
  * .mfc  — int32 big-endian count of float32 values, then the values
            (big-endian), 13 per frame (src/acmod.c:430-500 acmod_log_mfc;
            same as test/data/goforward.mfc).
  * .sen  — s3 text header {version, mdef_file, n_sen, logbase} + magic,
            then per frame: int16 n_active; if n_active == n_sen, int16
            scores[n_sen]; else uint8 deltas[n_active] followed by int16
            score per active senone (src/acmod.c:880-918 acmod_write_scores).
"""

from __future__ import annotations

import numpy as np

from .s3 import S3File


def read_mfc(path: str, cepsize: int = 13) -> np.ndarray:
    """Read a Sphinx .mfc file -> [n_frames, cepsize] float32.

    Endianness is auto-detected from the leading float count (the
    -mfclogdir dumps are big-endian; historical corpus files may be
    little-endian), as the reference does when reading control files."""
    with open(path, "rb") as f:
        data = f.read()
    avail = (len(data) - 4) // 4
    for en in (">", "<"):
        n = int(np.frombuffer(data, en + "i4", 1, 0)[0])
        if 0 < n <= avail:
            vals = np.frombuffer(data, en + "f4", n, 4).astype(np.float32)
            return vals.reshape(-1, cepsize)
    raise ValueError(f"{path}: bad .mfc float count")


def write_mfc(path: str, cep: np.ndarray):
    cep = np.asarray(cep, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(np.array([cep.size], dtype=">i4").tobytes())
        f.write(cep.astype(">f4").tobytes())


def read_sen(path: str):
    """Read a senone-score dump -> (scores int16 [n_frames, n_sen],
    active bool [n_frames, n_sen], logbase).  Inactive senones hold 0
    (the reference memsets scores to 0 each frame)."""
    f = S3File(path)
    n_sen = int(f.hdr["n_sen"])
    logbase = float(f.hdr.get("logbase", "1.0001"))
    data, pos = f.data, f.pos
    frames = []
    actives = []
    while pos + 2 <= len(data):
        n_active = int(np.frombuffer(data, "<i2", 1, pos)[0])
        pos += 2
        scores = np.zeros(n_sen, dtype=np.int16)
        act = np.zeros(n_sen, dtype=bool)
        if n_active == n_sen:
            scores[:] = np.frombuffer(data, "<i2", n_sen, pos)
            act[:] = True
            pos += 2 * n_sen
        else:
            deltas = np.frombuffer(data, np.uint8, n_active, pos)
            pos += n_active
            ids = np.cumsum(deltas.astype(np.int64))
            # First delta is an absolute id (reference accumulates from 0
            # with sen = senone_active[i] + lastsen, lastsen initially 0).
            vals = np.frombuffer(data, "<i2", n_active, pos)
            pos += 2 * n_active
            scores[ids] = vals
            act[ids] = True
        frames.append(scores)
        actives.append(act)
    return np.array(frames), np.array(actives), logbase


def write_sen(path: str, scores: np.ndarray, logbase: float = 1.0001,
              mdef_file: str = "none"):
    """Write an all-senone score dump in the reference's -senlogdir
    format (acmod_write_senfh_header + acmod_write_scores,
    src/acmod.c:334-918): s3 header, then per frame int16 n_active
    followed by int16 scores (all senones active)."""
    scores = np.asarray(scores)
    n_sen = scores.shape[1]
    with open(path, "wb") as f:
        f.write(b"s3\n")
        f.write(b"version 0.1\n")
        f.write(f"mdef_file {mdef_file}\n".encode())
        f.write(f"n_sen {n_sen}\n".encode())
        f.write(f"logbase {logbase:f}\n".encode())
        f.write(b"endhdr\n")
        f.write(np.array([0x11223344], dtype="<u4").tobytes())
        clipped = np.clip(np.rint(scores), -32768, 32767).astype("<i2")
        for t in range(scores.shape[0]):
            f.write(np.array([n_sen], dtype="<i2").tobytes())
            f.write(clipped[t].tobytes())
