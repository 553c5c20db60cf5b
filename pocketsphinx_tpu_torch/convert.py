"""Carry-over of parameters between the JAX package and the port.

Both packages build their model operands on the host with NumPy; these
functions turn such arrays into the port's device tensors.  They accept
the JAX package's own arrays (`AcousticModel.scoring_arrays` and
`cb_groups`, `NgramFusedDecoder._dev_tables` as NumPy) as well as the
port's, so a test can feed both packages the same parameters.

Tensor parallelism over a "model" group of devices splits two sets of
tables (the JAX package's TP shardings, without `NamedSharding`'s rule
that the split axis divide evenly): the scoring tables by codebooks or
senone slots (`split_scoring_tensors`), and the word-transition block's
LM tables by entry columns (`split_scan_tables`, `column_ranges`).
"""

from __future__ import annotations

import numpy as np
import torch


def _ranges(n: int, parts: int) -> list:
    """`parts` contiguous, near-equal [lo, hi) ranges covering range(n),
    the first n % parts of them one longer (as `np.array_split`)."""
    q, r = divmod(n, parts)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(parts)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def column_ranges(n_columns: int, tp: int) -> list:
    """The entry-column ranges [e0, e1) of a "model" group of `tp`
    devices: contiguous, near-equal, in order."""
    if not 1 <= tp <= n_columns:
        raise ValueError(f"cannot split {n_columns} columns over {tp} "
                         f"devices")
    return _ranges(n_columns, tp)


def _grouped_weights(w_lin, cb_groups):
    """[F, D, S] mixture weights -> [CB, F, D, Smax] per codebook group."""
    return w_lin[:, :, np.asarray(cb_groups["sen_pad"])].transpose(2, 0, 1, 3)


def _sen_slot(cb_groups, S):
    """Each senone's slot in the flattened [CB * Smax] group axis (CB *
    Smax for a senone in no group)."""
    sen_pad = np.asarray(cb_groups["sen_pad"])
    mask = np.asarray(cb_groups["mask"], bool)
    slot = np.full(S, sen_pad.size, np.int64)
    flat = np.nonzero(mask.reshape(-1))[0]
    slot[sen_pad.reshape(-1)[flat]] = flat
    return slot


def scoring_tensors(scoring_arrays: dict, cb_groups: dict, device) -> dict:
    """Scoring operands for `models.acoustic.senone_scores`:
    prec/muprec [CB, F, D, L], const [CB, F, D], w_lin [F, D, S], and for
    the block-diagonal (PTM/semi) product the per-codebook weights
    Wg [CB, F, D, Smax] with each senone's slot `sen_slot [S]` in the
    flattened [CB * Smax] group axis (CB * Smax for a senone in no
    group)."""
    dev = torch.device(device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    w_lin = np.asarray(scoring_arrays["w_lin"], np.float32)
    out = {k: t(np.asarray(scoring_arrays[k], np.float32))
           for k in ("prec", "muprec", "const")}
    out["w_lin"] = t(w_lin)
    CB = out["prec"].shape[0]
    S = w_lin.shape[-1]
    if CB != S:
        out["Wg"] = t(_grouped_weights(w_lin, cb_groups))
        out["sen_slot"] = t(_sen_slot(cb_groups, S))
    return out


def split_scoring_tensors(scoring_arrays: dict, cb_groups: dict,
                          devices) -> list:
    """The scoring operands split over a "model" group of devices, one
    dict per device, in the group's order:

      * `axis` "cb" when the codebook count CB divides by the group's
        size, and for a fully continuous model (whose codebooks are its
        senones) in near-equal ranges: each device holds its codebooks'
        Gaussians (prec, muprec, const) and mixture weights (Wg, or
        w_lin's columns);
      * `axis` "slot" otherwise: each device holds every Gaussian and a
        contiguous range of Wg's senone-slot axis.

    The first dict (the lead's) also holds `sen_slot`.  `senone_scores`,
    given the list, takes the per-stream norm and the per-frame max over
    the whole group and gathers the costs on the lead."""
    devs = [torch.device(d) for d in devices]
    tp = len(devs)
    w_lin = np.asarray(scoring_arrays["w_lin"], np.float32)
    gauss = {k: np.asarray(scoring_arrays[k], np.float32)
             for k in ("prec", "muprec", "const")}
    CB, S = gauss["prec"].shape[0], w_lin.shape[-1]
    cont = CB == S
    Wg = None if cont else _grouped_weights(w_lin, cb_groups)
    axis = "cb" if cont or CB % tp == 0 else "slot"
    n = CB if axis == "cb" else Wg.shape[-1]
    if tp > n:
        raise ValueError(f"cannot split {n} scoring {axis}s over {tp} "
                         f"devices")
    out = []
    for dev, (a, b) in zip(devs, _ranges(n, tp)):
        t = lambda x: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(x), device=dev)
        cb = slice(a, b) if axis == "cb" else slice(None)
        sh = {k: t(v[cb]) for k, v in gauss.items()}
        if cont:
            sh["w_lin"] = t(w_lin[..., a:b])
        else:
            sh["Wg"] = t(Wg[cb] if axis == "cb" else Wg[..., a:b])
        sh["axis"] = axis
        out.append(sh)
    if not cont:
        out[0]["sen_slot"] = torch.as_tensor(_sen_slot(cb_groups, S),
                                             device=devs[0])
    return out


def _planes(tp):
    """[D, W, N, N+1] transition tables -> [N*(N+1), D, W] planes."""
    D, W, N, N1 = tp.shape
    return np.ascontiguousarray(
        np.transpose(tp, (2, 3, 0, 1)).reshape(N * N1, D, W))


_INDEX_KEYS = ("fb_ci", "f0p_E", "guard_w", "guard_wf", "guard_fillw",
               "guard_fillwf", "col_lm_W", "bg_cols")

#: the word-transition block's tables with an entry-column (E) axis, by
#: that axis: each device of a "model" group holds its range of columns
COLUMN_AXES = {"rows": 1, "bg": 1, "ctx_next": 1, "fat_rows": 1,
               "fat_ctx": 1, "accept_T": 1, "uni_row": 0, "ctx_base": 0,
               "isfill_E": 0, "fillpen_E": 0, "isreal_E": 0, "lmwid_E": 0,
               "f0p_E": 0, "accept_bits": 1}
#: the block's tables of global column ids (scatter targets), rebased to
#: each device's range, an id outside it sent to the range's spare column
COLUMN_IDS = ("bg_cols", "tg2c", "tg_cols")
#: what else only the block reads, whole on each device of the group
COLUMN_WHOLE = ("rows_h", "bgmeta", "umeta", "bg_vals", "bg_ctx", "tg2v",
                "tg_vals")
#: tables the lead of a split group does not hold (the [E] tables the
#: lead's guard reads, `isfill_E`, `fillpen_E` and `f0p_E`, stay whole)
#: the transition kernel's own copies of the overlay lists, each row
#: sorted by column (`kernel_overlays`); built for each part after its
#: ids are rebased
KERNEL_OVERLAYS = ("tr_bg_cols", "tr_bg_vals", "tr_bg_ctx", "tr_tg_cols",
                   "tr_tg_vals")
_BLOCK_ONLY = (set(COLUMN_AXES) | set(COLUMN_IDS) | set(COLUMN_WHOLE)
               | set(KERNEL_OVERLAYS) | {"accept_E"}) - {
                   "isfill_E", "fillpen_E", "f0p_E"}


def accept_bits(accept_E) -> np.ndarray | None:
    """The accept table [E, n_ciph] of 0/1 values packed into
    NW = ceil(n_ciph / 64) int64 words per entry column, [NW, E]: bit
    c % 64 of word c // 64 for CI phone c (the transition kernel's form;
    a row of words is one coalesced read over consecutive columns).
    None when the table has other values."""
    acc = np.asarray(accept_E)
    if not np.isin(acc, (0, 1)).all():
        return None
    E, n = acc.shape
    bits = np.zeros((max(-(-n // 64), 1), E), np.uint64)
    for c in range(n):
        bits[c // 64] |= (acc[:, c] != 0).astype(np.uint64) << np.uint64(
            c % 64)
    return bits.view(np.int64)


def _sort_rows(cols, vals, off, cnt):
    """Copies of `cols` (as int32) and of each array in `vals` in which
    the entries [off[r], off[r] + cnt[r]) of every row r are sorted by
    column; entries outside every row keep their place.  Rows must not
    overlap."""
    cnt = np.maximum(np.asarray(cnt, np.int64), 0)
    off = np.asarray(off, np.int64)
    n = int(cnt.sum())
    pos = np.repeat(off, cnt) + (np.arange(n)
                                 - np.repeat(np.cumsum(cnt) - cnt, cnt))
    if n and (pos.min() < 0 or pos.max() >= len(cols)
              or len(np.unique(pos)) != n):
        raise ValueError("overlay rows overlap or leave their table")
    row = np.repeat(np.arange(len(cnt)), cnt)
    order = pos[np.lexsort((cols[pos], row))]
    out = [np.array(cols, np.int32)] + [np.array(v) for v in vals]
    for o, v in zip(out, [cols] + list(vals)):
        o[pos] = v[order]
    return out


def kernel_overlays(tabs: dict) -> dict:
    """The transition kernel's copies of the block's sparse overlays
    (NumPy in, NumPy out), each row sorted by column, so that a block of
    the kernel finds the entries of its column tile by binary search:
    mode C's CSR bigram rows (`tr_bg_cols` int32, `tr_bg_vals`,
    `tr_bg_ctx`: history h's row holds umeta[h, 1] entries from
    umeta[h, 0]) and the trigram corrections (`tr_tg_cols` int32,
    `tr_tg_vals`, in the layout of `tg2c`/`tg2v` or of the flat
    `tg_cols`/`tg_vals`: bigram context i's row holds bgmeta[i, 4]
    entries).  A row's columns are unique, so a sorted row applies the
    same overlay as the original; an id outside a part's range (its spare
    column) sorts last."""
    out = {}
    if "umeta" in tabs and "bg_cols" in tabs:
        um = np.asarray(tabs["umeta"], np.int64)
        (out["tr_bg_cols"], out["tr_bg_vals"],
         out["tr_bg_ctx"]) = _sort_rows(
            np.asarray(tabs["bg_cols"]), [tabs["bg_vals"], tabs["bg_ctx"]],
            um[:, 0], um[:, 1])
    if "bgmeta" in tabs and ("tg2c" in tabs or "tg_cols" in tabs):
        meta = np.asarray(tabs["bgmeta"], np.int64)
        two_d = "tg2c" in tabs
        cols = np.asarray(tabs["tg2c" if two_d else "tg_cols"])
        vals = np.asarray(tabs["tg2v" if two_d else "tg_vals"])
        S = cols.shape[-1] if two_d else 0
        off = np.arange(len(meta)) * S if two_d else meta[:, 3]
        cnt = np.minimum(meta[:, 4], S) if two_d else meta[:, 4]
        c, v = _sort_rows(cols.reshape(-1), [vals.reshape(-1)], off, cnt)
        out["tr_tg_cols"], out["tr_tg_vals"] = (c.reshape(cols.shape),
                                                v.reshape(vals.shape))
    return out


def _host_forms(tables: dict) -> dict:
    """The scan tables as the port's NumPy forms (see `scan_tables`)."""
    tabs = {k: np.asarray(v) for k, v in tables.items()}
    for k in [k for k in tabs if k.startswith("fd_oh")]:
        tabs["fd_idx" + k[5:]] = np.argmax(tabs.pop(k), axis=0)
    if "lp_oh" in tabs:
        tabs["lp_idx"] = np.argmax(tabs.pop("lp_oh"), axis=0)
        if tabs["tp_fin"].shape[1] == 3:      # the fan kernel's layout
            tp_fin = tabs.pop("tp_fin")
            tabs["tp_fin12"] = tp_fin.transpose(1, 2, 0).reshape(
                12, tp_fin.shape[0])
    if "f0_onehot" in tabs:
        tabs["f0p_E"] = np.argmax(tabs.pop("f0_onehot"), axis=1)
    if "rows" in tabs:
        # mode rows: each context's (h1, h2) ride as two last columns
        tabs["rows_h"] = tabs["rows"][:, -2:]
        tabs["rows"] = tabs["rows"][:, :-2]
    tabs["accept_T"] = tabs["accept_E"].T
    bits = accept_bits(tabs["accept_E"])
    if bits is not None:
        tabs["accept_bits"] = bits
    tabs.update(kernel_overlays(tabs))
    for k, v in tabs.items():
        if k.startswith(("ch_tp", "ci_tp")):
            v = _planes(v.astype(np.float32))
        elif k.startswith(("fd_idx", "ch_nv", "lp_idx")) or k in (
                "lmwid_E", "etgt0", "lc_cls_T"):
            v = v.astype(np.int32)
        elif k in _INDEX_KEYS:
            v = v.astype(np.int64)
        tabs[k] = v
    return tabs


def _upload(tabs: dict, device, cache=None) -> dict:
    """NumPy tables -> contiguous tensors on `device`; `cache` (key,
    device) -> tensor shares a whole table between two parts of a group
    on one device."""
    dev = torch.device(device)
    out = {}
    for k, v in tabs.items():
        if cache is not None and (k, dev) in cache:
            out[k] = cache[k, dev]
            continue
        v = np.ascontiguousarray(v)
        out[k] = torch.as_tensor(v if v.flags.writeable else v.copy(),
                                 device=dev)
        if cache is not None:
            cache[k, dev] = out[k]
    for k in [k for k in out if k.startswith(("ch_fm", "ci_fm"))]:
        # first depth per word (exactly one first-node row per word)
        out[k.replace("_fm", "_fd")] = torch.argmax(
            out[k].to(torch.int32), dim=0)
    return out


def scan_tables(tables: dict, device) -> dict:
    """Scan tables on `device` for `search.ngram_fused`.

    tables: the port decoder's `host_tables`, or the JAX decoder's
    `_dev_tables` as NumPy, in any LM mode (mode C's CSR keys `uni_row`,
    `umeta`, `fat_rows`, `fat_ctx`, `ctx_base`, `bg_cols`, `bg_vals`,
    `bg_ctx`) and with `PS_GUARD_TOPM`'s `guard_bmax`, `col_lm_W` and
    `isfill_W` (one-hot expansion tables are turned into the
    index form the port gathers with: `fd_oh{b}` -> `fd_idx{b}`,
    `lp_oh`/`tp_fin` -> `lp_idx`/`tp_fin12` (3 states; other
    topologies keep `tp_fin`), `f0_onehot` -> `f0p_E`; index columns
    become int64; mode rows' [R, E + 2] `rows` becomes `rows` [R, E]
    and its (h1, h2) columns `rows_h` [R, 2]; `accept_T` is `accept_E`
    transposed, and `accept_bits` [NW, E] its rows packed one bit per CI
    phone for the transition kernel, where `accept_bits` can; the kernel's
    sorted copies of the overlay lists, `kernel_overlays`).
    The decoder's `device_tables` lays the chain tables and `senid_all`
    out for its scan."""
    return _upload(_host_forms(tables), device)


def split_scan_tables(tables: dict, device, shards) -> tuple:
    """`scan_tables` with the word-transition block split by entry
    columns over a "model" group: `shards` lists (device, e0, e1) in
    column order (`column_ranges`).  Returns (the lead's tables on
    `device`: every table but the block's own; [(device, that device's
    block tables)]).  A device's block tables are the columns [e0, e1)
    of each `COLUMN_AXES` table, the `COLUMN_IDS` tables rebased to e0
    (ids outside the range -> e1 - e0, the block's spare scatter
    column), the kernel's sorted overlays of the rebased ids
    (`kernel_overlays`) and the `COLUMN_WHOLE` tables whole (one copy
    per device)."""
    host = _host_forms(tables)
    lead = _upload({k: v for k, v in host.items() if k not in _BLOCK_ONLY},
                   device)
    whole, parts = {}, []
    for dev, e0, e1 in shards:
        part = {}
        for k, ax in COLUMN_AXES.items():
            if k in host:
                v = host[k]
                part[k] = v[e0:e1] if ax == 0 else v[:, e0:e1]
        for k in COLUMN_IDS:
            if k in host:
                c = host[k]
                part[k] = np.where((c >= e0) & (c < e1), c - e0,
                                   e1 - e0).astype(c.dtype)
        part.update(kernel_overlays(dict(
            part, **{k: host[k] for k in COLUMN_WHOLE if k in host})))
        block = _upload(part, dev)
        block.update(_upload({k: host[k] for k in COLUMN_WHOLE if k in host},
                             dev, whole))
        parts.append((torch.device(dev), block))
    return lead, parts
