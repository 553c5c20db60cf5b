"""Sound file parsing (WAV/NIST/raw int16) — src/util/soundfiles.c
equivalent.  Returns (pcm int16 numpy array, sample rate).

A copy of `pocketsphinx_tpu.fileio.sound`."""

from __future__ import annotations

import numpy as np


def read_audio(path: str, default_samprate: int = 16000):
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return _parse_wav(data, path)
    if data[:7] == b"NIST_1A":
        return _parse_nist(data)
    # raw 16-bit little-endian PCM
    return np.frombuffer(data[:len(data) & ~1], dtype="<i2"), \
        default_samprate


def _parse_wav(data: bytes, path: str):
    pos = 12
    rate = 16000
    nch = 1
    bits = 16
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = int(np.frombuffer(data, "<u4", 1, pos + 4)[0])
        body = pos + 8
        if cid == b"fmt ":
            fmt = int(np.frombuffer(data, "<u2", 1, body)[0])
            nch = int(np.frombuffer(data, "<u2", 1, body + 2)[0])
            rate = int(np.frombuffer(data, "<u4", 1, body + 4)[0])
            bits = int(np.frombuffer(data, "<u2", 1, body + 14)[0])
            if fmt != 1 or bits != 16:
                raise ValueError(f"{path}: only 16-bit PCM WAV supported")
        elif cid == b"data":
            pcm = np.frombuffer(data, "<i2", size // 2, body)
        pos = body + size + (size & 1)
    if pcm is None:
        raise ValueError(f"{path}: no data chunk")
    if nch > 1:
        pcm = pcm.reshape(-1, nch)[:, 0].copy()
    return pcm, rate


def _parse_nist(data: bytes):
    hdr_len = int(data[8:16].split()[0])
    hdr = data[16:hdr_len].decode("latin-1", errors="replace")
    rate = 16000
    for line in hdr.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[0] == "sample_rate":
            rate = int(parts[2])
    pcm = np.frombuffer(data, "<i2", (len(data) - hdr_len) // 2, hdr_len)
    return pcm, rate
