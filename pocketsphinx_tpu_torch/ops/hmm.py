"""Dense token-passing HMM update in torch — the hmm_vit_eval equivalent
(src/hmm.c:222-470) for any leading batch shape and 3- or 5-state
left-to-right (1-skip) topologies.  Port of `pocketsphinx_tpu.ops.hmm`.

Semantics replicated exactly:
  * emissions attach to the *source* state (s_i = score_i + sen_i before
    transitions);
  * the non-emitting exit is computed from pre-update values with
    sources (N-2, N-1), tie -> lower state;
  * states update top-down in place, candidate priority on ties:
    from(j-1) > self > skip(j-2);
  * state 0 only self-loops (entries are applied by the caller after the
    step, taking effect next frame, per hmm_enter).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def hmm_step(S, sen_t, tp):
    """One frame of Viterbi for [..., N]-state HMMs.

    S     [..., N]      state scores (goodness, bigger better)
    sen_t [..., N]      per-state senone goodness increments (<= 0)
    tp    [..., N, N+1] transition goodness (-cost; NEG_INF = impossible)

    Returns (newS [..., N], src [..., N] int32 source state per target,
             out [...], out_src [...] int32).
    """
    N = S.shape[-1]
    s = S + sen_t
    cand_out = torch.stack([s[..., N - 2] + tp[..., N - 2, N],
                            s[..., N - 1] + tp[..., N - 1, N]], dim=-1)
    out, oc = torch.max(cand_out, dim=-1)          # first max on ties
    out_src = (N - 2 + oc).to(torch.int32)

    new_states, srcs = [], []
    for j in range(N - 1, 0, -1):
        cands = [s[..., j - 1] + tp[..., j - 1, j],
                 s[..., j] + tp[..., j, j]]
        if j >= 2:
            cands.append(s[..., j - 2] + tp[..., j - 2, j])
        best, a = torch.max(torch.stack(cands, dim=-1), dim=-1)
        new_states.append(best)
        # candidate a is state j-1 (a=0), j (a=1) or j-2 (a=2)
        srcs.append(torch.where(a == 2, j - 2, j - 1 + a).to(torch.int32))
    new_states.append(s[..., 0] + tp[..., 0, 0])
    srcs.append(torch.zeros_like(out_src))
    return (torch.stack(new_states[::-1], dim=-1),
            torch.stack(srcs[::-1], dim=-1), out, out_src)


def propagate_meta(meta, src):
    """Gather per-state metadata along the chosen sources:
    meta [..., N] -> new meta [..., N]."""
    return torch.gather(meta, -1, src.long())


def out_meta(meta, out_src):
    """Metadata of the exit's source state: [..., N] -> [...]."""
    return torch.gather(meta, -1, out_src.long()[..., None])[..., 0]


def hmm_step_sm(S, sen_t, tp, metas=()):
    """State-major Viterbi step.

    S      tuple of N tensors [...]: per-state scores
    sen_t  tuple of N tensors [...]: senone goodness increments
    tp     [..., N, N+1] transition goodness (indexed statically)
    metas  list of tuples-of-N metadata tensors to propagate alongside

    Returns (newS tuple, new_metas list, out, out_sel bool [...]
    (True = exit came from state N-1), out_metas list of [...]).
    Tie semantics identical to hmm_step / hmm_vit_eval.
    """
    N = len(S)
    s = [S[j] + sen_t[j] for j in range(N)]
    lo = s[N - 2] + tp[..., N - 2, N]
    hi = s[N - 1] + tp[..., N - 1, N]
    hi_wins = hi > lo
    out = torch.where(hi_wins, hi, lo)
    out_metas = [torch.where(hi_wins, m[N - 1], m[N - 2]) for m in metas]

    newS = [None] * N
    new_metas = [[None] * N for _ in metas]
    for j in range(N - 1, 0, -1):
        prev = s[j - 1] + tp[..., j - 1, j]
        self_ = s[j] + tp[..., j, j]
        best = torch.maximum(prev, self_)
        take_self = self_ > prev
        if j >= 2:
            skip = s[j - 2] + tp[..., j - 2, j]
            take_skip = skip > best
            best = torch.where(take_skip, skip, best)
        newS[j] = best
        for mi, m in enumerate(metas):
            v = torch.where(take_self, m[j], m[j - 1])
            if j >= 2:
                v = torch.where(take_skip, m[j - 2], v)
            new_metas[mi][j] = v
    newS[0] = s[0] + tp[..., 0, 0]
    for mi, m in enumerate(metas):
        new_metas[mi][0] = m[0]
    return tuple(newS), [tuple(nm) for nm in new_metas], out, hi_wins, \
        out_metas
