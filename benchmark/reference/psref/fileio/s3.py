"""Sphinx-3 binary file substrate: "s3" header + byte-order magic + raw arrays.

NumPy re-implementation of the reference reader (src/util/bio.c:188-265).
All acoustic-model parameter files (means, variances, mixture_weights,
transition_matrices) share this container format:

    "s3\n"
    "<key> <value>\n" ...        (e.g. version, chksum0)
    "endhdr\n"
    uint32 0x11223344            (byte-order magic, native endian of writer)
    ... raw binary arrays ...
    [uint32 checksum]            (if chksum0 present in header)
"""

from __future__ import annotations

import numpy as np

BYTE_ORDER_MAGIC = 0x11223344


class S3File:
    """Sequential reader over an s3-format binary file."""

    def __init__(self, path: str, verify: bool = False):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        self.hdr: dict[str, str] = {}
        self.pos = 0
        self._chksum = np.uint32(0)
        self._verify = verify  # checksum accumulation is sequential; opt-in
        self._parse_header()

    def _readline(self) -> str:
        nl = self.data.find(b"\n", self.pos)
        if nl < 0:
            raise ValueError(f"{self.path}: not an s3 model file "
                             "(no header line found)")
        line = self.data[self.pos:nl].decode("latin-1")
        self.pos = nl + 1
        return line

    def _parse_header(self):
        first = self._readline()
        if first == "s3":
            while True:
                line = self._readline()
                parts = line.split()
                if parts and parts[0] == "endhdr":
                    break
                if not parts or parts[0].startswith("#"):
                    continue
                if len(parts) >= 2:
                    self.hdr[parts[0]] = parts[1]
        else:
            # Old format: version line, then comment until *end_comment*
            self.hdr["version"] = first.split()[0] if first.split() else ""
            while True:
                line = self._readline()
                if line == "*end_comment*":
                    break
        magic = np.frombuffer(self.data, dtype="<u4", count=1, offset=self.pos)[0]
        if magic == BYTE_ORDER_MAGIC:
            self.endian = "<"
        else:
            magic_be = np.frombuffer(self.data, dtype=">u4", count=1, offset=self.pos)[0]
            if magic_be != BYTE_ORDER_MAGIC:
                raise ValueError(f"{self.path}: bad byte-order magic {magic:#x}")
            self.endian = ">"
        self.pos += 4
        self.chksum_present = "chksum0" in self.hdr

    # -- typed reads ---------------------------------------------------------

    def read(self, dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype).newbyteorder(self.endian)
        arr = np.frombuffer(self.data, dtype=dt, count=count, offset=self.pos)
        self.pos += dt.itemsize * count
        if self.chksum_present and self._verify:
            self._accum(arr, dt.itemsize)
        return arr.astype(arr.dtype.newbyteorder("="))

    def read_int32(self) -> int:
        return int(self.read(np.int32, 1)[0])

    def read_1d(self, dtype) -> np.ndarray:
        n = self.read_int32()
        return self.read(dtype, n)

    def read_3d(self, dtype) -> np.ndarray:
        d1 = self.read_int32()
        d2 = self.read_int32()
        d3 = self.read_int32()
        arr = self.read_1d(dtype)
        return arr.reshape(d1, d2, d3)

    # -- checksum (src/util/bio.c:267-297) -----------------------------------

    def _accum(self, arr: np.ndarray, itemsize: int):
        if itemsize == 1:
            vals, rot = arr.view(np.uint8).astype(np.uint64), 5
        elif itemsize == 2:
            vals, rot = arr.view(np.uint16).astype(np.uint64), 10
        elif itemsize == 4:
            vals, rot = arr.view(np.uint32).astype(np.uint64), 20
        else:
            return
        s = np.uint64(self._chksum)
        m = np.uint64(0xFFFFFFFF)
        for v in vals:  # rotate-accumulate; cheap relative to model-load matmuls
            s = ((s << np.uint64(rot)) | (s >> np.uint64(32 - rot))) & m
            s = (s + v) & m
        self._chksum = np.uint32(s)

    def verify_chksum(self):
        if not self.chksum_present:
            return
        if not self._verify:
            self.pos += 4
            return
        want = np.frombuffer(
            self.data, dtype=np.dtype(np.uint32).newbyteorder(self.endian),
            count=1, offset=self.pos)[0]
        self.pos += 4
        if np.uint32(self._chksum) != want:
            raise ValueError(f"{self.path}: checksum mismatch "
                             f"{self._chksum:#x} != {want:#x}")

    def at_eof(self) -> bool:
        return self.pos >= len(self.data)


def read_s3_3d_float(path: str, verify: bool = False) -> tuple[dict, np.ndarray]:
    """Read a generic [d1][d2][d3] float32 s3 file (not used for gauden,
    whose layout is stream-heterogeneous; see fileio/acoustic.py)."""
    f = S3File(path)
    arr = f.read_3d(np.float32)
    if verify:
        f.verify_chksum()
    return f.hdr, arr
