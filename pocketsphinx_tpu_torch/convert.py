"""Carry-over of parameters between the JAX package and the port.

Both packages build their model operands on the host with NumPy; these
functions turn such arrays into the port's device tensors.  They accept
the JAX package's own arrays (`AcousticModel.scoring_arrays` and
`cb_groups`, `NgramFusedDecoder._dev_tables` as NumPy) as well as the
port's, so a test can feed both packages the same parameters.
"""

from __future__ import annotations

import numpy as np
import torch


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
        sen_pad = np.asarray(cb_groups["sen_pad"])
        mask = np.asarray(cb_groups["mask"], bool)
        out["Wg"] = t(w_lin[:, :, sen_pad].transpose(2, 0, 1, 3))
        slot = np.full(S, sen_pad.size, np.int64)
        flat = np.nonzero(mask.reshape(-1))[0]
        slot[sen_pad.reshape(-1)[flat]] = flat
        out["sen_slot"] = t(slot)
    return out


def _planes(tp):
    """[D, W, N, N+1] transition tables -> [N*(N+1), D, W] planes."""
    D, W, N, N1 = tp.shape
    return np.ascontiguousarray(
        np.transpose(tp, (2, 3, 0, 1)).reshape(N * N1, D, W))


_INDEX_KEYS = ("fb_ci", "f0p_E", "guard_w", "guard_wf", "guard_fillw",
               "guard_fillwf", "col_lm_W", "bg_cols")


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
    become int64).
    The decoder's `device_tables` lays the chain tables and `senid_all`
    out for its scan."""
    dev = torch.device(device)
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
    out = {}
    for k, v in tabs.items():
        if k.startswith(("ch_tp", "ci_tp")):
            v = _planes(v.astype(np.float32))
        elif k.startswith(("fd_idx", "ch_nv", "lp_idx")) or k in (
                "lmwid_E", "etgt0", "lc_cls_T"):
            v = v.astype(np.int32)
        elif k in _INDEX_KEYS:
            v = v.astype(np.int64)
        v = np.ascontiguousarray(v)
        out[k] = torch.as_tensor(v if v.flags.writeable else v.copy(),
                                 device=dev)
    for k in [k for k in out if k.startswith(("ch_fm", "ci_fm"))]:
        # first depth per word (exactly one first-node row per word)
        out[k.replace("_fm", "_fd")] = torch.argmax(
            out[k].to(torch.int32), dim=0)
    out["accept_T"] = out["accept_E"].T.contiguous()
    return out
