"""Binary model-definition ("BMDF") reader — the triphone inventory.

NumPy re-implementation of src/bin_mdef.c:323-525 (bin_mdef_read).  Maps
(base, left-context, right-context, word-position) -> phone id -> senone
sequence id (ssid) + transition-matrix id; sseq[ssid] gives the senone id
per emitting state.

On-disk layout (little- or big-endian, see src/bin_mdef.h:63-112):
    int32 magic 'BMDF', int32 version, int32 hdrlen, hdrlen bytes text
    10 x int32: n_ciphone n_phone n_emit_state n_ci_sen n_sen n_tmat
                n_sseq n_ctx n_cd_tree sil
    CI phone names (NUL-separated), padded to 4 bytes
    cd_tree_t[n_cd_tree]: {int16 ctx, int16 n_down, int32 pid_or_down}
    mdef_entry_t[n_phone]: {int32 ssid, int32 tmat, 4 bytes info}
    int32 sseq_size, uint16 sseq[sseq_size], [uint8 sseq_len[n_sseq]]
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NATIVE_MAGIC = 0x46444D42  # 'BMDF' little-endian
OTHER_MAGIC = 0x424D4446
FORMAT_VERSION = 1

# word_posn_t (src/mdef.h:69-81)
WPOS_INTERNAL = 0
WPOS_BEGIN = 1
WPOS_END = 2
WPOS_SINGLE = 3
N_WORD_POSN = 4
WPOS_NAME = "ibesu"
SILENCE_CIPHONE = "SIL"
BAD_SSID = 0xFFFF
BAD_SENID = 0xFFFF


@dataclass
class BinMdef:
    n_ciphone: int
    n_phone: int
    n_emit_state: int
    n_ci_sen: int
    n_sen: int
    n_tmat: int
    n_sseq: int
    n_ctx: int
    sil: int
    ciname: list[str]
    # cd_tree flattened arrays
    cd_ctx: np.ndarray            # int16 [n_cd_tree]
    cd_n_down: np.ndarray         # int16
    cd_down: np.ndarray           # int32 (pid if leaf)
    # phones
    phone_ssid: np.ndarray        # int32 [n_phone]
    phone_tmat: np.ndarray        # int32 [n_phone]
    phone_filler: np.ndarray      # bool  [n_phone] (CI attr; CD inherits base)
    phone_ci: np.ndarray          # int32 [n_phone] base CI phone of each phone
    phone_lc: np.ndarray          # int32 left ctx (-1 for CI)
    phone_rc: np.ndarray          # int32 right ctx (-1 for CI)
    phone_wpos: np.ndarray        # int32 word position (-1 for CI)
    sseq: np.ndarray              # uint16 [n_sseq, n_emit_state]
    # derived
    cd2cisen: np.ndarray = field(default=None, repr=False)
    sen2cimap: np.ndarray = field(default=None, repr=False)
    _ciname_index: dict = field(default=None, repr=False)
    _ciname_lower: dict = field(default=None, repr=False)

    # -- lookups (mirror bin_mdef.h accessor macros) -------------------------

    def ciphone_id(self, name: str, nocase: bool = False) -> int:
        """bin_mdef_ciphone_id / _nocase (src/bin_mdef.c:690-733)."""
        if self._ciname_index is None:
            self._ciname_index = {n: i for i, n in enumerate(self.ciname)}
        p = self._ciname_index.get(name, -1)
        if p < 0 and nocase:
            if self._ciname_lower is None:
                self._ciname_lower = {n.lower(): i
                                      for i, n in enumerate(self.ciname)}
            p = self._ciname_lower.get(name.lower(), -1)
        return p

    def is_filler(self, p: int) -> bool:
        return bool(self.phone_filler[p])

    def phone_id(self, ci: int, lc: int, rc: int, wpos: int) -> int:
        """bin_mdef_phone_id (src/bin_mdef.c:744-811): cd_tree walk."""
        if lc < 0 or rc < 0:
            return ci
        sil = self.sil
        ctx = (
            wpos,
            ci,
            sil if (sil >= 0 and self.phone_filler[lc]) else lc,
            sil if (sil >= 0 and self.phone_filler[rc]) else rc,
        )
        base = 0
        max_n = N_WORD_POSN
        for level in range(4):
            seg = self.cd_ctx[base:base + max_n]
            hits = np.nonzero(seg == ctx[level])[0]
            if len(hits) == 0:
                return -1
            i = base + int(hits[0])
            if self.cd_n_down[i] == 0:
                return int(self.cd_down[i])
            max_n = int(self.cd_n_down[i])
            base = int(self.cd_down[i])
        return -1

    def phone_id_nearest(self, b: int, l: int, r: int, pos: int) -> int:
        """bin_mdef_phone_id_nearest (src/bin_mdef.c:812-864): word-position
        and silence-context backoff."""
        if l < 0 or r < 0:
            return b
        p = self.phone_id(b, l, r, pos)
        if p >= 0:
            return p
        for tmppos in range(N_WORD_POSN):
            if tmppos != pos:
                p = self.phone_id(b, l, r, tmppos)
                if p >= 0:
                    return p
        if self.sil >= 0:
            newl, newr = l, r
            if self.phone_filler[l] or pos in (WPOS_BEGIN, WPOS_SINGLE):
                newl = self.sil
            if self.phone_filler[r] or pos in (WPOS_END, WPOS_SINGLE):
                newr = self.sil
            if (newl, newr) != (l, r):
                p = self.phone_id(b, newl, newr, pos)
                if p >= 0:
                    return p
                for tmppos in range(N_WORD_POSN):
                    if tmppos != pos:
                        p = self.phone_id(b, newl, newr, tmppos)
                        if p >= 0:
                            return p
        return b

    def dense_pid_table(self) -> np.ndarray:
        """Dense [N_WORD_POSN, n_ci, n_ci, n_ci] phone-id table
        (wpos, base, lc, rc) -> pid or -1, built by one DFS over the
        cd_tree — the vectorizable equivalent of bin_mdef_phone_id.
        Contexts must be pre-mapped (fillers -> SIL) by the caller,
        as phone_id does."""
        if getattr(self, "_pid_table", None) is not None:
            return self._pid_table
        nc = self.n_ciphone
        tbl = np.full((N_WORD_POSN, nc, nc, nc), -1, dtype=np.int32)
        ctx = self.cd_ctx
        ndown = self.cd_n_down
        down = self.cd_down
        # level order: wpos, base, lc, rc
        stack = [(i, 0, ()) for i in range(min(N_WORD_POSN, len(ctx)))]
        while stack:
            i, level, path = stack.pop()
            c = int(ctx[i])
            nd = int(ndown[i])
            if nd == 0:
                # Leaf: fill the (possibly partial) context slice — the
                # reference stops the walk at any leaf (bin_mdef.c:800-802).
                coords = path + (c,)
                tbl[coords] = int(down[i])
                continue
            base = int(down[i])
            for j in range(base, base + nd):
                stack.append((j, level + 1, path + (c,)))
        self._pid_table = tbl
        return tbl

    def _build_ci_maps(self):
        """cd2cisen / sen2cimap construction (src/bin_mdef.c:480-512)."""
        self.cd2cisen = np.full(self.n_sen, -1, dtype=np.int16)
        self.cd2cisen[:self.n_ci_sen] = np.arange(self.n_ci_sen)
        self.sen2cimap = np.full(self.n_sen, -1, dtype=np.int16)
        sens = self.sseq[self.phone_ssid]               # [n_phone, n_emit]
        cis = self.phone_ci
        # First write wins (C iterates phones outer, states inner); emulate
        # by assigning in reverse flat order so the earliest lands last.
        flat_s = sens.reshape(-1).astype(np.int64)
        flat_ci = np.repeat(cis, self.n_emit_state)
        self.sen2cimap[flat_s[::-1]] = flat_ci[::-1]
        # cd2cisen: senone in state j of phone p maps to CI phone's state-j senone
        ci_ssid = self.phone_ssid[cis]
        ci_sens = self.sseq[ci_ssid]
        for j in range(self.n_emit_state):
            self.cd2cisen[sens[:, j]] = ci_sens[:, j]


def read_text_mdef(path: str) -> BinMdef:
    """Sphinx-3 text model-definition parser (src/mdef.c re-design).

    Format: version line (0.3), "<n> n_base / n_tri / n_state_map /
    n_tied_state / n_tied_ci_state / n_tied_tmat" count lines, then one
    row per phone: base lft rt wpos attrib tmat state-ids... N."""
    counts = {}
    rows = []
    version = None
    for raw in open(path):
        line = raw.split("#")[0].strip()
        if not line:
            continue
        parts = line.split()
        if version is None:
            version = parts[0]
            continue
        if len(parts) == 2 and parts[1].startswith("n_"):
            counts[parts[1]] = int(parts[0])
            continue
        rows.append(parts)
    n_ci = counts.get("n_base", 0)
    n_sen = counts.get("n_tied_state", 0)
    n_ci_sen = counts.get("n_tied_ci_state", n_sen)
    n_tmat = counts.get("n_tied_tmat", 0)
    n_phone = n_ci + counts.get("n_tri", 0)
    if version not in ("0.3",) or not rows:
        raise ValueError(f"{path}: not a Sphinx-3 text mdef")
    if len(rows) != n_phone:
        raise ValueError(f"{path}: {len(rows)} phone rows != {n_phone}")
    n_emit = len(rows[0]) - 7  # base lft rt p attrib tmat ... N
    ciname = [r[0] for r in rows[:n_ci]]
    cidx = {n: i for i, n in enumerate(ciname)}
    wpos_map = {c: i for i, c in enumerate(WPOS_NAME)}
    phone_ssid = np.zeros(n_phone, np.int32)
    phone_tmat = np.zeros(n_phone, np.int32)
    phone_ci = np.arange(n_phone, dtype=np.int32)
    phone_lc = np.full(n_phone, -1, np.int32)
    phone_rc = np.full(n_phone, -1, np.int32)
    phone_wpos = np.full(n_phone, -1, np.int32)
    filler = np.zeros(n_phone, bool)
    sseqs: dict[tuple, int] = {}
    sseq_rows = []
    pid_table = np.full((N_WORD_POSN, n_ci, n_ci, n_ci), -1, np.int32)
    for p, r in enumerate(rows):
        base, lft, rt, wp, attrib, tmat = r[:6]
        states = tuple(int(s) for s in r[6:6 + n_emit])
        if states not in sseqs:
            sseqs[states] = len(sseq_rows)
            sseq_rows.append(states)
        phone_ssid[p] = sseqs[states]
        phone_tmat[p] = int(tmat)
        filler[p] = attrib == "filler"
        if lft != "-":
            phone_ci[p] = cidx[base]
            phone_lc[p] = cidx[lft]
            phone_rc[p] = cidx[rt]
            phone_wpos[p] = wpos_map.get(wp, 0)
            pid_table[phone_wpos[p], phone_ci[p], phone_lc[p],
                      phone_rc[p]] = p
    filler = filler[phone_ci]
    m = BinMdef(
        n_ciphone=n_ci, n_phone=n_phone, n_emit_state=n_emit,
        n_ci_sen=n_ci_sen, n_sen=n_sen, n_tmat=n_tmat,
        n_sseq=len(sseq_rows), n_ctx=3, sil=-1, ciname=ciname,
        cd_ctx=np.zeros(0, np.int16), cd_n_down=np.zeros(0, np.int16),
        cd_down=np.zeros(0, np.int32),
        phone_ssid=phone_ssid, phone_tmat=phone_tmat,
        phone_filler=filler, phone_ci=phone_ci, phone_lc=phone_lc,
        phone_rc=phone_rc, phone_wpos=phone_wpos,
        sseq=np.asarray(sseq_rows, dtype=np.uint16))
    m.sil = m.ciphone_id(SILENCE_CIPHONE)
    m._pid_table = pid_table
    m._build_ci_maps()
    return m


def _build_cd_tree(m: BinMdef):
    """Construct the 4-level context-decision tree (wpos -> base -> lc ->
    rc leaf) from the phone arrays, with the reference's node layout
    (bin_mdef_read_text, src/bin_mdef.c:156-255): all wpos nodes first,
    then all base nodes, then all lc nodes, then the rc leaves.  The
    reference builds its per-(wpos, base) lc/rc linked lists by
    prepending (src/mdef.c:149-167), so list order is the reverse of
    first appearance in the text mdef; we reproduce that to keep
    text->binary conversion byte-compatible."""
    n_ci = m.n_ciphone
    # per (wpos, ci): ordered {lc: [(rc, pid)]}
    table = [[{} for _ in range(n_ci)] for _ in range(N_WORD_POSN)]
    for p in range(n_ci, m.n_phone):
        lcs = table[int(m.phone_wpos[p])][int(m.phone_ci[p])]
        lcs.setdefault(int(m.phone_lc[p]), []).append((int(m.phone_rc[p]), p))
    ctx, n_down, down = [], [], []

    def add(c, nd, dn):
        ctx.append(c)
        n_down.append(nd)
        down.append(dn)

    # index bases per level
    ci_base = N_WORD_POSN
    lc_base = ci_base + N_WORD_POSN * n_ci
    n_lc = sum(len(table[i][j]) for i in range(N_WORD_POSN)
               for j in range(n_ci))
    rc_base = lc_base + n_lc
    for i in range(N_WORD_POSN):
        add(i, n_ci, ci_base + i * n_ci)
    lc_idx, rc_idx = lc_base, rc_base
    lc_nodes, rc_nodes = [], []
    for i in range(N_WORD_POSN):
        for j in range(n_ci):
            lcs = table[i][j]
            if not lcs:
                add(j, 0, -1)
                continue
            add(j, len(lcs), lc_idx)
            for lc, rcs in reversed(list(lcs.items())):
                lc_nodes.append((lc, len(rcs), rc_idx))
                for rc, pid in reversed(rcs):
                    rc_nodes.append((rc, 0, pid))
                    rc_idx += 1
                lc_idx += 1
    for node in lc_nodes + rc_nodes:
        add(*node)
    m.cd_ctx = np.asarray(ctx, np.int16)
    m.cd_n_down = np.asarray(n_down, np.int16)
    m.cd_down = np.asarray(down, np.int32)


_HDR_TEXT = (b"pocketsphinx-tpu binary mdef: header counts, NUL-separated "
             b"CI phone names, cd_tree {i16 ctx, i16 n_down, i32 pid/down}, "
             b"phones {i32 ssid, i32 tmat, u8 info[4]}, i32 sseq_size, "
             b"u16 sseq[]\0")


def write_bin_mdef(m: BinMdef, path: str):
    """Binary BMDF writer (bin_mdef_write, src/bin_mdef.c:524-602);
    output loads in the reference (header text is skipped on read)."""
    if m.cd_ctx.size == 0:
        # CI-only models still carry the empty wpos/base scaffold
        _build_cd_tree(m)
    hdrlen = (len(_HDR_TEXT) + 3) & ~3
    out = bytearray()
    out += np.array([NATIVE_MAGIC, FORMAT_VERSION, hdrlen],
                    "<i4").tobytes()
    out += _HDR_TEXT + b"\0" * (hdrlen - len(_HDR_TEXT))
    out += np.array([m.n_ciphone, m.n_phone, m.n_emit_state, m.n_ci_sen,
                     m.n_sen, m.n_tmat, m.n_sseq, m.n_ctx, len(m.cd_ctx),
                     m.sil], "<i4").tobytes()
    for name in m.ciname:
        out += name.encode("latin-1") + b"\0"
    out += b"\0" * (-len(out) % 4)
    tree = np.zeros(len(m.cd_ctx),
                    np.dtype([("ctx", "<i2"), ("n_down", "<i2"),
                              ("down", "<i4")]))
    tree["ctx"], tree["n_down"], tree["down"] = \
        m.cd_ctx, m.cd_n_down, m.cd_down
    out += tree.tobytes()
    ph = np.zeros(m.n_phone, np.dtype([("ssid", "<i4"), ("tmat", "<i4"),
                                       ("info", np.uint8, 4)]))
    ph["ssid"], ph["tmat"] = m.phone_ssid, m.phone_tmat
    nc = m.n_ciphone
    ph["info"][:nc, 0] = m.phone_filler[:nc]
    if m.n_phone > nc:
        ph["info"][nc:, 0] = m.phone_wpos[nc:]
        ph["info"][nc:, 1] = m.phone_ci[nc:]
        ph["info"][nc:, 2] = m.phone_lc[nc:]
        ph["info"][nc:, 3] = m.phone_rc[nc:]
    out += ph.tobytes()
    out += np.array([m.n_sseq * m.n_emit_state], "<i4").tobytes()
    out += m.sseq.astype("<u2").tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_text_mdef(m: BinMdef, path: str):
    """Sphinx-3 text mdef writer (bin_mdef_write_text,
    src/bin_mdef.c:604-694); field widths match the reference so text
    output is byte-comparable."""
    import contextlib
    import sys
    with (contextlib.nullcontext(sys.stdout) if path == "-"
          else open(path, "w")) as f:
        _write_text_mdef(m, f)


def _write_text_mdef(m: BinMdef, f):
    f.write("0.3\n")
    f.write(f"{m.n_ciphone} n_base\n")
    f.write(f"{m.n_phone - m.n_ciphone} n_tri\n")
    f.write(f"{m.n_phone * (m.n_emit_state + 1)} n_state_map\n")
    f.write(f"{m.n_sen} n_tied_state\n")
    f.write(f"{m.n_ci_sen} n_tied_ci_state\n")
    f.write(f"{m.n_tmat} n_tied_tmat\n")
    f.write("#\n# Columns definitions\n")
    f.write("#%4s %3s %3s %1s %6s %4s %s\n"
            % ("base", "lft", "rt", "p", "attrib", "tmat",
               "     ... state id's ..."))
    for p in range(m.n_phone):
        if p < m.n_ciphone:
            f.write("%5s %3s %3s %1s" % (m.ciname[p], "-", "-", "-"))
        else:
            f.write("%5s %3s %3s %c"
                    % (m.ciname[m.phone_ci[p]], m.ciname[m.phone_lc[p]],
                       m.ciname[m.phone_rc[p]], WPOS_NAME[m.phone_wpos[p]]))
        f.write(" %6s" % ("filler" if m.phone_filler[p] else "n/a"))
        f.write(" %4d" % m.phone_tmat[p])
        for s in m.sseq[m.phone_ssid[p]]:
            f.write(" %6u" % s)
        f.write(" N\n")


def read_bin_mdef(path: str) -> BinMdef:
    with open(path, "rb") as f:
        data = f.read(4)
    magic = np.frombuffer(data, "<u4", 1, 0)[0]
    if magic != NATIVE_MAGIC and np.frombuffer(data, ">u4", 1, 0)[0] \
            != NATIVE_MAGIC:
        # try the Sphinx-3 text format (bin_mdef_read does this first)
        return read_text_mdef(path)
    with open(path, "rb") as f:
        data = f.read()
    magic = np.frombuffer(data, "<u4", 1, 0)[0]
    if magic == NATIVE_MAGIC:
        en = "<"
    elif np.frombuffer(data, ">u4", 1, 0)[0] == NATIVE_MAGIC:
        en = ">"
    else:
        raise ValueError(f"{path}: not a BMDF file")
    i32 = np.dtype(np.int32).newbyteorder(en)
    i16 = np.dtype(np.int16).newbyteorder(en)
    u16 = np.dtype(np.uint16).newbyteorder(en)

    def rd32(off, count=1):
        return np.frombuffer(data, i32, count, off).astype(np.int32)

    version, hdrlen = int(rd32(4)[0]), int(rd32(8)[0])
    if version > FORMAT_VERSION:
        raise ValueError(f"{path}: format version {version} too new")
    pos = 12 + hdrlen
    (n_ciphone, n_phone, n_emit_state, n_ci_sen, n_sen, n_tmat,
     n_sseq, n_ctx, n_cd_tree, sil) = (int(x) for x in rd32(pos, 10))
    pos += 40
    # CI names: NUL-separated strings.
    ciname = []
    for _ in range(n_ciphone):
        end = data.index(b"\0", pos)
        ciname.append(data[pos:end].decode("latin-1"))
        pos = end + 1
    pos = (pos + 3) & ~3
    # cd_tree: 8-byte records {i16 ctx, i16 n_down, i32 down}
    rec = np.frombuffer(data, np.dtype([("ctx", i16), ("n_down", i16),
                                        ("down", i32)]), n_cd_tree, pos)
    pos += 8 * n_cd_tree
    cd_ctx = rec["ctx"].astype(np.int16)
    cd_n_down = rec["n_down"].astype(np.int16)
    cd_down = rec["down"].astype(np.int32)
    # phones: 12-byte records {i32 ssid, i32 tmat, u8 info[4]}
    prec = np.frombuffer(data, np.dtype([("ssid", i32), ("tmat", i32),
                                         ("info", np.uint8, 4)]), n_phone, pos)
    pos += 12 * n_phone
    phone_ssid = prec["ssid"].astype(np.int32)
    phone_tmat = prec["tmat"].astype(np.int32)
    info = prec["info"]
    # CI phones: info[0] = filler flag.  CD phones: info = {wpos, ctx[3]}
    # where ctx = {base, left, right} (see bin_mdef_phone_str,
    # src/bin_mdef.c:866-886).
    phone_ci = np.arange(n_phone, dtype=np.int32)
    phone_lc = np.full(n_phone, -1, dtype=np.int32)
    phone_rc = np.full(n_phone, -1, dtype=np.int32)
    phone_wpos = np.full(n_phone, -1, dtype=np.int32)
    if n_phone > n_ciphone:
        cd = info[n_ciphone:]
        phone_wpos[n_ciphone:] = cd[:, 0]
        phone_ci[n_ciphone:] = cd[:, 1]
        phone_lc[n_ciphone:] = cd[:, 2]
        phone_rc[n_ciphone:] = cd[:, 3]
    ci_filler = info[:n_ciphone, 0].astype(bool)
    phone_filler = ci_filler[phone_ci]
    # sseq
    sseq_size = int(rd32(pos)[0])
    pos += 4
    sseq_flat = np.frombuffer(data, u16, sseq_size, pos).astype(np.uint16)
    pos += 2 * sseq_size
    if n_emit_state:
        sseq = sseq_flat.reshape(n_sseq, n_emit_state)
    else:
        raise NotImplementedError("heterogeneous topologies not supported")

    m = BinMdef(
        n_ciphone=n_ciphone, n_phone=n_phone, n_emit_state=n_emit_state,
        n_ci_sen=n_ci_sen, n_sen=n_sen, n_tmat=n_tmat, n_sseq=n_sseq,
        n_ctx=n_ctx, sil=sil, ciname=ciname,
        cd_ctx=cd_ctx, cd_n_down=cd_n_down, cd_down=cd_down,
        phone_ssid=phone_ssid, phone_tmat=phone_tmat,
        phone_filler=phone_filler, phone_ci=phone_ci,
        phone_lc=phone_lc, phone_rc=phone_rc, phone_wpos=phone_wpos,
        sseq=sseq)
    m.sil = m.ciphone_id(SILENCE_CIPHONE)
    m._build_ci_maps()
    return m
