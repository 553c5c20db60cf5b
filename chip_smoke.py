"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --tp [--profile]
    python3 chip_smoke.py --ab TREE [TREE ...]

Drives `pocketsphinx_tpu_torch` (never the JAX package) on CUDA:

1. device: the card's name and power limit; builds the CUDA kernels
   (`pocketsphinx_tpu_torch/csrc/*.cu`, one nvcc per source, in
   parallel) into build/torch_kernels/;
2. the fan kernel against its plain torch version at the main path's
   shapes (B=8; the fan carry padded to a multiple of 4 columns), ties
   on and off, bit-equal, with the exit plane written into a strided
   view of a wider buffer and the partial maxima of the new scores
   (`check_fan`); both timed with CUDA events as device time (calls
   captured in a CUDA graph and replayed) and as per call through the
   Python wrapper, and the kernel at each choice of its plane groups;
3. the grouped chain kernel (one launch per frame over every chain
   bucket) the same way at the 20k-word decoder's bucket list (the
   variant buckets and the CI bucket), against its plain version, ties
   on and off; then the word-transition kernel (`check_transitions`, one
   launch per frame over every entry column) on a real frame's top-K
   exits of that decoder (LM mode B), on the same exits with ties
   (`tie_exits`) and with one live exit (`solo_exits`), at its default
   launch shape and at each launch option (columns per thread x splits
   of the exits), all seven outputs bit-equal to its plain version,
   timed as in phase 2 (each option too), with each option's shared
   memory; nvcc's registers and spills of each kernel instance; (b)
   `check_phones`: a small model with 70 CI phones (two accept words per
   column) in LM modes B and C, the kernel held the same way on a K = W
   frame, and a decode on the card equal to the CPU's;
4. torch's argmax / max(dim) / stable sort tie order on CUDA (first
   maximum, lower index first), which the scan's exactness relies on;
5. the main path at full width: a seeded synthetic acoustic model at
   en-us's shapes over bench_data/bench-20k.dic and bench-20k.lm.bin
   (LM mode B), seeded PCM -> MFCC -> features -> senone scores -> fused
   n-gram scan -> backtrace: 3 utterances through `decode`, one B=8
   batch through `decode_batch(keep_records=False)`, the scan through
   its CUDA graph (the default); the kernels' launch counts over that
   run; the first utterance's records, hypothesis and segments held
   bit-equal against the same port run on the CPU with the plain
   kernels, from the same cost matrix; then the batch's costs (unequal
   lengths) through the graph and stepped eagerly (`graph_vs_eager`),
   minimal and full records: records, carries, hypotheses, segments,
   scores and guard counts equal;
6. with --profile only: torch.profiler over 64 scan steps of the B=8
   decode, device time by kernel, the device's busy share, device
   launches and device ms per frame and the fan's and the word-transition
   kernel's shares of the device time; then `scan_modes`, the scan
   through the graph and stepped eagerly: wall and device ms per frame,
   busy share, device and host launches per frame, peak memory (and the
   same at the 126k width in phase 9(a));
7. the `Decoder` facade at the same width: a synthetic en-us-shaped
   model directory (`synth.SynthModel.write_model_dir`) with
   bench-20k.dic and bench-20k.lm.bin, on CUDA: the seconds to build
   the LM's host lookup maps, which the best-path pass needs; (a) two
   seeded utterances through `decode_raw` with the best-path pass, their
   stage seconds and lattice sizes, the first one's records, lattice
   lists and best-path result held equal to the same decoder moved to
   the CPU (`Decoder._to`) decoding the same cost matrix; (b) one utterance
   streamed through `process_raw` in 0.1 s chunks with `partial_hyp`
   after each, the seconds of each 32-frame block, and the streamed
   records held bit-equal to one whole-utterance scan of the same costs
   on the card; (c) the kernels' launches over (a) and (b) equal the
   frames the scans stepped; (d) `stream_graph_check`: the stream
   stepped eagerly by a twin (`Decoder._to(..., graph=False)`) fed the
   same costs gives the same records and hypotheses, and a carry
   resumed at frame 37 gives the same records and carry through the
   graph, eagerly and on the CPU;
8. the other search modes through the `Decoder` at the same width, on
   phase 7's model directory with bench-20k.dic (`modes`): (a) a seeded
   command grammar, `public <cmd> = <verb> <object> [<mod>];` with rules
   of 200, 1,000 and 100 words, through `decode_raw` with the best-path
   pass; (b) 20 seeded keyphrases through `add_kws`; (c) allphone over CI
   phones with a seeded phone-bigram LM, and over the triphone net
   without an LM; (d) `add_align_text` of 40 words; each one utterance,
   its search's size (A arcs, P HMM rows, N allphone nodes), search
   seconds and ms per frame, then held equal (records, hypothesis,
   segments, lattice, alignment) to `Decoder._to("cpu")` decoding the
   same costs; (e) a 5-state synthetic model over bench-20k.dic and
   bench-20k.lm.bin: the chain kernel at NST=5 against its plain version
   at that decoder's bucket list (ties on and off, timed as in phase 3),
   one 2 s utterance through `decode_raw` with fan launches 0 and chain
   launches equal to the frames stepped, and its records held equal to
   the CPU's;
9. the reference scale and the corpus path: (a) the 126k-word task,
   bench-135k.lm.bin (V=126,032) over `synth.dictionary_for_lm` of its
   vocabulary with bench-20k.dic's pronunciations and a synthetic
   en-us-shaped model over it (`reference_scale`): LM mode C (asserted),
   the LM read and decoder build seconds, W, E, the chain buckets, the
   fat rows and SB, and the three kernels held bit-equal to their plain
   versions at this decoder's shapes (ties on and off; the transition
   kernel in LM mode C) and timed as in phases 2-3; (b) `BatchDecodePipeline.decode_corpus` on one card of 16
   seeded utterances of 2-5 s (two B=8 batches), three times: audio-s/s (the
   median), stage seconds, peak memory, the guard count, fan and chain
   launches equal to the frames stepped; then one B=8 batch of short
   utterances, the first 1 s long, through `decode_batch`'s minimal
   records, each row's hypothesis, segments and score equal to its own
   B=1 full-record decode of the same costs, that batch through the
   graph and stepped eagerly (`graph_vs_eager`), and the 1 s row decoded
   by the decoder moved to the CPU, records, hypothesis, segments and
   score equal to the card's; (c) `TwoStagePipeline`
   over the same utterances, equal to (b); (d) `guard_topm` (run right
   after phase 5, before its decoder is freed): PS_GUARD_TOPM=64 on
   phase 5's 20k decoder, one B=8 batch, every record
   but `nviol` and the hypotheses equal to GM=0, both guard counts and
   peak memories; (e) `batch_cli`: `cli_batch.main` over a synthetic model
   directory with bench-1.7k.dic and bench-1.7k.lm.bin and eight seeded
   WAV files (`-adcin yes`), at `-batchsize 8` and 1, identical `-hyp`
   and `-hypseg` files; (e') `rows_transitions`: the word-transition
   kernel in LM mode rows, on a decoder of bench-1.7k.dic and
   bench-1.7k.lm.bin, as in phase 3;
10. the command-line program, the compat API and the flat search:
   (a) `cli_20k`: `cli.main` in-process on phase 7's model directory
   with bench-20k.dic and bench-20k.lm.bin, `single` on a seeded 2 s WAV
   and `live` over 8 s of seeded bursts and silences (the WebRTC VAD
   must find 2 or more segments), each command building its own
   `Decoder`, every JSON line equal to one `Decoder` built here (`single`
   through `decode_raw`, each `live` segment streamed through
   `process_raw` as `live` does), fan and chain launches equal to the
   frames stepped, each command's seconds; (a') `cli_1k7`, on phase
   9(e)'s model directory with bench-1.7k.dic and bench-1.7k.lm.bin:
   `align` of 20 words with -phone_align and -state_align yes equal to
   `Decoder.get_alignment` of the same PCM, and `compat.AudioFile` over
   (a)'s `live` file giving `live`'s hypotheses; (b) `flat_1k7`: the
   flat search (PS_NGRAM_IMPL=flat) at the 1.7k width, one B=8 batch of
   seeded 2-5 s utterances through `decode_batch`, every row's 7 record
   arrays, hypothesis and segments equal to the same search on the CPU
   from the same costs, ms per frame and peak memory, one `decode_raw`
   with the best-path pass, and how many hypotheses the fused search
   gives equal (counted, not required); (c) `flat_20k`: the flat search
   at the 20k width, a 2 s utterance at B=1 equal to its own row of a B=2
   `decode_batch`, ms per frame and peak memory of each; (d)
   `topk_exact`, run right after phase 9(d) on phase 5's decoder: two of
   phase 5's utterances at K=96 and unpruned (K=W), hypotheses, segments
   and exit records held equal where the K run's guard count is 0;
11. tensor parallelism over the mesh's "model" axis (`tensor_parallel`:
   `decode_corpus` on a mesh whose rows split the scoring by codebooks
   or senone slots and the scan's word-transition block by the LM
   tables' entry columns, `NgramFusedDecoder.shard`), once per mesh,
   each split scan through its CUDA graph (one graph over the group's
   cards): the fan and the chain launch once per frame stepped, on the
   leads, the transition kernel once per frame and part; each data
   row's split costs against the unsplit scoring (largest difference
   printed, within the scoring tolerance); the (hyp, segments) and the
   guard count equal the unsplit run's where the costs are equal, and
   always equal the unsplit search's on the split costs; the first
   row's minimal records through the graph equal its eager step's and
   the unsplit scan's; audio-s/s, scan ms per frame, peak memory per
   card, the split replica's graph buffers, and the device ms of one
   frame's block as the scan runs it (`block_times`: each part's, the
   whole split block's, and its copies and joins alone).  (a) `tp_20k`, right after
   phase 10(d): phase 5's decoder (LM mode B) in two parts on one card
   (`Mesh([["cuda:0", "cuda:0"]])`), one B=8 batch, beside the unsplit
   run, and `graph_vs_eager` on the split replica (minimal and full
   records, carries, `decode_batch`'s results); (b) `tp_126k`, right
   after phase 9(c): phase 9's decoder (LM mode
   C) and its 16 utterances in two parts on one card, against phase
   9(b)'s first run; (c) with two or more cards, over cards 0 and 1
   (`make_mesh(1, 2)`); (d) with four, `make_mesh(2, 2)`, 8 utterances
   per data row.  (c) and (d) print that they were skipped on fewer
   cards.  With --profile, `split_scan_modes` of (a)'s, (b)'s and (c)'s
   groups: the split scan through its graph and stepped eagerly beside
   the unsplit decoder's, as `scan_modes` (peak memory per card).

Every phase that decodes with the n-gram search holds each kernel's
launches to the frames it stepped (the word-transition kernel once per
frame on each part of a "model" group).  Prints the kernels' JSON line
(the three kernels at the 20k shapes with the main path's launches,
phase 11(a)'s (`tp_launches`), phase 7's (`facade_launches`) and phase
10(a)'s (`cli_launches`), the transition kernel's LM-mode-rows check as
`rows_*` and its 70-phone check as `phones_*`; then at the 126k shapes,
`*_126k`, with phase 9(b)'s and phase 11(b)-(d)'s), the card's name and
power limit, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises; without CUDA it exits non-zero before any
result.

`--tp` runs phase 11(b)-(d) alone (phase 9's task built and decoded
once unsplit as their reference), e.g. on a machine with four cards,
with `split_scan_modes` of (b)'s and (c)'s groups; with `--profile` it
also profiles (c)'s split scan through its graph and the unsplit one
(each card's busy share).

`--ab TREE [TREE ...]` compares checkouts instead (e.g. the parent
commit unpacked with `git archive`): for each TREE in the order given,
in a process of its own and with that tree's code, it builds the kernels
and phase 5's 20k-word decoder, runs this script's `scan_modes` on it
(a B=8 batch of seeded 2-5 s utterances, minimal records, and a B=1
utterance with full records, the shape of `decode` and the stream, each
through the graph and stepped eagerly where the tree has the graph),
times the fan
kernel at the 20k and 126k shapes (the tree's `check_fan`) and the
word-transition kernel at the 20k (mode B) and 1.7k (mode rows) shapes,
builds phase 9's 126k decoder and runs both `scan_modes` and the
word-transition kernel's timing on it (`check_transitions`), and prints
one JSON line per tree and one line per width and path.
Give the trees in turns (A B B A) to see the host's drift.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(HERE, "bench_data")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# helpers (importable without CUDA)
# ---------------------------------------------------------------------------

def fan_inputs(rng, B, NRC, W, LP, ties):
    """Random fan-step inputs in the style of tests/test_pallas_fan.py for
    W multi-phone words: the carry, lp and tp padded to the fan carry's
    width (`fan.padded_width`), with pads (lp's out of range) that no
    result may read."""
    from pocketsphinx_tpu_torch.ops.fan import padded_width
    Wp = padded_width(W)
    S = rng.uniform(-50, 0, (B, 3, NRC, Wp)).astype(np.float32)
    pred = rng.uniform(-50, 0, (B, W)).astype(np.float32)
    tp = rng.uniform(-12, 0, (12, Wp)).astype(np.float32)
    if ties:
        S, pred, tp = np.round(S), np.round(pred), np.round(tp)
    S[:, 0, :, : W // 7] = NEG_INF
    pred[:, ::5] = NEG_INF
    tp[3] = NEG_INF
    lp = rng.integers(0, LP, Wp).astype(np.int32)
    lp[W:] = LP + 7
    return dict(
        S=S, TF=rng.integers(0, 400, (B, 3, NRC, Wp)).astype(np.int32),
        CX=rng.integers(0, 1 << 20, (B, 3, NRC, Wp)).astype(np.int32),
        pred=pred, ptf=rng.integers(0, 400, (B, W)).astype(np.int32),
        pcx=rng.integers(0, 1 << 20, (B, W)).astype(np.int32),
        pre=rng.uniform(0, 60, (B, 3, NRC, LP)).astype(np.float32),
        lp=lp, tp=tp)


def chain_inputs(rng, B, NST, D, W, RF, NFD, has_var, ties):
    """Random chain-step inputs in the style of tests/test_pallas_chain.py
    (RF/NFD unused without variants)."""
    S = (rng.standard_normal((B, NST, D, W)) * 30).astype(np.float32)
    tp = -(rng.random((NST * (NST + 1), D, W)) * 5).astype(np.float32)
    if ties:
        S, tp = np.round(S), np.round(tp)
    fd = rng.integers(0, D, W)
    out = dict(
        S=S, TF=rng.integers(0, 99, (B, NST, D, W)).astype(np.int32),
        CTX=rng.integers(0, 999, (B, NST, D, W)).astype(np.int32),
        VAR=None, pre=(rng.random((B, NST, D, W)) * 80).astype(np.float32),
        prevd=None, fd_idx=None, tp=tp,
        fm=np.arange(D)[:, None] == fd[None, :], nv=None,
        pip=float(np.float32(-0.7)))
    if has_var:
        out.update(
            VAR=rng.integers(0, RF, (B, NST, W)).astype(np.int32),
            prevd=(rng.random((B, NST, RF, NFD)) * 80).astype(np.float32),
            fd_idx=rng.integers(0, NFD, W).astype(np.int32),
            nv=rng.integers(1, RF + 1, W).astype(np.int32))
    return out


def chain_group_args(per, device):
    """A `ChainGroup` on `device` over the buckets of `per` (chain_inputs
    dicts, in layout order) and the grouped step's keyword arguments:
    the flat carry, the g row and pip."""
    import torch
    from pocketsphinx_tpu_torch.ops.chain import ChainGroup
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    B, NST = per[0]["S"].shape[:2]
    buckets = []
    for p in per:
        b = dict(tp=t(p["tp"]), fm=t(p["fm"]))
        if p["VAR"] is not None:
            b.update(nv=t(p["nv"]), fd_idx=t(p["fd_idx"]),
                     RF=p["prevd"].shape[2], NFD=p["prevd"].shape[3])
        buckets.append(b)
    grp = ChainGroup(NST, buckets)

    def flat(key):
        xs = [p[key].reshape(-1) for p in per if p[key] is not None]
        return t(np.concatenate(xs) if xs else np.zeros(0, np.int32))

    g = grp.row([t(p["pre"]).reshape(B, -1) for p in per],
                [t(p["prevd"]).reshape(B, -1) for p in per
                 if p["prevd"] is not None])
    return grp, dict(S=flat("S"), TF=flat("TF"), CTX=flat("CTX"),
                     VAR=flat("VAR"), g=g, pip=per[0]["pip"])


#: the port's kernels, by their module in `pocketsphinx_tpu_torch.ops`
KERNELS = ("fan", "chain", "transitions")


def _kernel_modules():
    from pocketsphinx_tpu_torch.ops import chain, fan, transitions
    return dict(fan=fan, chain=chain, transitions=transitions)


def reset_counts():
    """Set every kernel's launch count to 0."""
    for m in _kernel_modules().values():
        m.reset_launches()


def counts():
    """Every kernel's launches since `reset_counts`, by name."""
    return {k: m.launches for k, m in _kernel_modules().items()}


def frame_exits(dec, costs):
    """The word-transition block's arguments (block tables, LM layout,
    kv, ki, ctx_k, fb_k, svk, wpen) at the last frame of a short
    minimal-record scan of `costs` [B, T, n_sen] (at most two chunks):
    one tuple for each part of `dec`'s "model" group (one unsplit)."""
    import torch
    from pocketsphinx_tpu_torch.search import ngram_fused
    seen, inner = [], ngram_fused.transitions

    def spy(*a, **k):
        seen.append(a)
        return inner(*a, **k)
    ngram_fused.transitions = spy
    try:
        T = min(costs.shape[1], 2 * dec.CHUNK)
        dec.scan(costs[:, :T], torch.ones(costs.shape[0], T, dtype=torch.bool,
                                          device=dec.device), minimal=True,
                 graph=False)
    finally:
        ngram_fused.transitions = inner
    parts = dec.tables["columns"]
    return seen[-(1 if parts is None else len(parts)):]


def tie_exits(args, rng, n_pairs=24, n_dead=5):
    """`frame_exits` arguments with ties: `n_pairs` random exits k2 take
    the context, final phone, score and exit planes of an earlier exit
    k1 (so every column's cand ties between them, and only the winner's
    word id tells them apart), and `n_dead` exits are dead (kv NEG_INF)."""
    tb, lm, kv, ki, ctx_k, fb_k, svk, wpen = args
    kv, ctx_k, fb_k, svk = (x.clone() for x in (kv, ctx_k, fb_k, svk))
    K = kv.shape[1]
    if K > 1:
        for _ in range(n_pairs):
            k1, k2 = sorted(rng.choice(K, 2, replace=False).tolist())
            for x in (kv, ctx_k, fb_k):
                x[:, k2] = x[:, k1]
            svk[:, :, k2] = svk[:, :, k1]
    kv[:, rng.choice(K, min(n_dead, K), replace=False).tolist()] = NEG_INF
    return tb, lm, kv, ki, ctx_k, fb_k, svk, wpen


def solo_exits(args):
    """`frame_exits` arguments in which one exit is live and the others
    dead (kv NEG_INF), so that its candidate wins at every column where
    the accept table takes it: every column's LM score under that exit
    reaches the outputs.  The exit is the one with the most trigram
    corrections (modes B and C), else the first."""
    import torch
    tb, lm, kv, ki, ctx_k, fb_k, svk, wpen = args
    k = 0
    if lm.mode != "rows" and lm.s_tri:
        ctx = ctx_k[0].long()
        bidx = (ctx - 1 - lm.V).clamp(0, max(lm.n_bg - 1, 0))
        n_tri = (tb["bgmeta"][bidx, 4] * (ctx > lm.V)).to(torch.int64)
        k = int(torch.argmax(n_tri))
    kv = torch.full_like(kv, NEG_INF)
    kv[:, k] = args[2][:, k]
    return tb, lm, kv, ki, ctx_k, fb_k, svk, wpen


def to_device(args, device):
    import torch
    return {k: (torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
                else v) for k, v in args.items()}


def nbytes(args, outs):
    """Bytes a step must move: every input read once, every output
    written once."""
    tot = sum(v.nbytes for v in args.values() if isinstance(v, np.ndarray))
    return tot + sum(o.numel() * o.element_size() for o in outs)


def compare(outs, refs, what):
    """Bit-equality of kernel and plain outputs (on the outputs' device);
    returns max |diff|."""
    import torch
    err = 0.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        r = r.to(o.device)
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"{what}: output {i} {o.shape}/{o.dtype} "
                                 f"!= {r.shape}/{r.dtype}")
        if not torch.equal(o, r):
            bad = int((o != r).sum())
            raise AssertionError(f"{what}: output {i} differs at {bad} "
                                 f"elements")
        if o.is_floating_point():
            err = max(err, float((o.double() - r.double()).abs().max())
                      if o.numel() else 0.0)
    return err


def time_ms(fn, reps=20, trials=21, graph=False):
    """Milliseconds per call of fn() on the card: CUDA events around
    `reps` back-to-back calls, after a warm-up; the median of `trials`
    such runs.  With `graph`, the `reps` calls are captured once in a
    CUDA graph and the events time its replay: the device time of the
    calls' kernels, without the host's cost of issuing them."""
    import torch
    from pocketsphinx_tpu_torch import graph_capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                       # warm-up
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    run = lambda: [fn() for _ in range(reps)]           # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with graph_capture(g):
            run()
        run = g.replay
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def timings(fn, plain):
    """Kernel and plain version, each as device time (graph replay) and
    as per call through Python: (ms, plain_ms, wrapper_ms,
    plain_wrapper_ms)."""
    return (time_ms(fn, graph=True), time_ms(plain, graph=True),
            time_ms(fn), time_ms(plain))


def bound_ms(n_bytes, n_ops):
    """(least time, what bounds it): bytes over the memory rate vs
    float32 operations over the card's float32 rate."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def build_decoder(dic, lmfile, workdir, device, n_sen=None, n_density=None,
                  **dec_kw):
    """Seeded synthetic en-us-shaped model over `dic` + the LM file ->
    (port NgramFusedDecoder on `device`, frontend); `dec_kw` go to the
    decoder."""
    from pocketsphinx_tpu_torch.testing import synth

    kw = {k: v for k, v in (("n_sen", n_sen), ("n_density", n_density))
          if v is not None}
    spec = synth.make_model([dic], seed=0, **kw)
    dec = synth.build_decoder(spec, workdir, dic, lmfile, device=device,
                              **dec_kw)
    return dec, en_us_frontend()


def en_us_frontend():
    """The batched frontend with en-us's feat.params."""
    from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
    return MelFrontend(nfilt=25, lowerf=130, upperf=6800, transform="dct",
                       lifter_val=22, remove_noise=True)


def buckets_of(dec):
    """The chain kernel's bucket list of a decoder, (NST, D, W, RF, NFD,
    has_var) each in layout order: the variant buckets, then the CI
    buckets."""
    out = [(dec.NST, c.D, c.Wb, c.RF, c.senid_first_d.shape[-1], True)
           for c in dec.chains]
    return out + [(dec.NST, c.D, c.Wb, 0, 0, False) for c in dec.ci_chains]


def seg_key(segs):
    """Segments as comparable (word, start, end) tuples."""
    return [(s.word, s.start, s.end) for s in segs]


def _sync(device):
    """Wait for `device` (a no-op off CUDA); then the host clock."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def _peak(device):
    import torch
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)


def _reset_peak(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def _env(name, value):
    """`os.environ[name]` set to `value` inside the block, and back to what
    it was (or unset) after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _write_wav(path, pcm, rate=16000):
    import wave
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(pcm, "<i2").tobytes())
    return path


def check_cpu_equal(dec, costs, raw, hyp, segs, score, device):
    """The decode of `costs` [T, n_sen] on `device` (its raw records,
    hypothesis, segments and score) equals the same decoder's on the CPU
    with the plain kernels."""
    cpu = dec.to("cpu")
    hyp_c, segs_c = cpu.decode(None, costs=costs.cpu())
    names = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
    for n, a, b in zip(names, raw, cpu.raw_records):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{device} vs cpu records differ: {n}")
    if (hyp, seg_key(segs), score) != (hyp_c, seg_key(segs_c),
                                       cpu.hyp_score):
        raise AssertionError(f"{device} vs cpu hypothesis differs: "
                             f"{hyp!r} / {hyp_c!r}")
    return {"frames": int(costs.shape[0]), "hyp": hyp, "records_equal": True}


def graph_vs_eager(dec, costs, nf, what, log=print):
    """The scan of `costs` [B, T, n_sen] (rows of `nf` frames) through the
    chunk's CUDA graph (the default) and stepped eagerly (`graph=False`),
    with minimal and with full records: records and the carry after the
    last frame bit-equal, and `decode_batch`'s hypotheses, segments,
    scores and guard counts equal.  Returns what it held equal."""
    import torch
    valid = (torch.arange(costs.shape[1], device=costs.device)[None, :]
             < torch.as_tensor(nf, device=costs.device)[:, None])
    res = dict(B=int(costs.shape[0]), frames=[int(x) for x in nf])
    for minimal in (True, False):
        kind = "minimal" if minimal else "full"
        (rg, cg), (re, ce) = (dec._scan(costs, valid, minimal, graph=g)
                              for g in (True, False))
        for i, (a, b) in enumerate(zip(rg, re, strict=True)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {kind} record {i}: graph "
                                     f"!= eager")
        for (n, a), (_, b) in zip(dec._carry_fields(cg),
                                  dec._carry_fields(ce), strict=True):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {kind} carry {n}: graph != "
                                     f"eager")
        del rg, re, cg, ce
        outs = []
        for g in (True, False):
            out = _results(dec.decode_batch(None, nf, keep_records=not minimal,
                                            costs=costs, graph=g))
            outs.append((out, list(dec.hyp_scores),
                         list(dec.guard_violations_batch)))
        if outs[0] != outs[1]:
            raise AssertionError(f"{what}: {kind} decode_batch: graph != "
                                 f"eager")
        res[kind] = dict(records_equal=True, carry_equal=True,
                         hyps=[h for h, _ in outs[0][0]][:3])
    log(f"{what}: graph == eager: " + json.dumps(res))
    return res


def _host_launches(prof):
    """Launches the host issued in a profile: the CUDA API calls
    (`cuda*`, `cu*`) that put work on a stream (kernels, graphs, copies,
    fills), by name."""
    from torch.autograd import DeviceType
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
             "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
             "cuMemcpyAsync", "cuMemsetD")
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key.startswith(names)}


def scan_modes(dec, fe, log=print, batch=8, reps=4, frames=64,
               minimal=True):
    """The scan of a B=`batch` batch of seeded 2-5 s utterances (`minimal`
    or full records) through the chunk's CUDA graph and stepped eagerly, each in
    turn, eager first (a tree without the graph: its one scan): the wall
    ms per frame of `reps` scans, peak memory over them (allocated and
    reserved, from a reset before the first scan, so a graph's capture is
    in it when the decoder had none at this shape; for a decoder split
    over a "model" group also the allocated peak of each card), and over
    one profiled scan of `frames` frames the device ms per frame (summed
    over the cards), the devices' busy share of its wall, the device
    launches per frame (kernels, copies and fills; a replay's kernels
    count one each) and the launches the host issued per frame.  Works
    with any tree's decoder (`--ab`)."""
    import inspect
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores

    pcm, ns = pcm_batch(list(range(10, 10 + batch)),
                        list(np.linspace(2.0, 5.0, batch)))
    feats, _ = features(fe, pcm, ns, dec.device)
    costs = senone_scores(dec.scoring(), feats, time_chunk=16)
    valid = torch.ones(costs.shape[:2], dtype=torch.bool, device=dec.device)
    T = costs.shape[1]
    modes = ({"eager": dict(graph=False), "graph": dict(graph=True)}
             if "graph" in inspect.signature(dec.scan).parameters
             else {"default": {}})
    cards = sorted({d.index for d in getattr(dec, "model_devices", None)
                    or [dec.device]})

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    out = {}
    for mode, kw in modes.items():
        sync()
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        ms = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            dec.scan(costs, valid, minimal=minimal, **kw)
            sync()
            ms.append((time.perf_counter() - t0) / T * 1e3)
        r = dict(wall_ms_per_frame=ms,
                 peak_alloc_bytes=torch.cuda.max_memory_allocated(dec.device),
                 peak_reserved_bytes=torch.cuda.max_memory_reserved(
                     dec.device),
                 peak_alloc_bytes_by_card={
                     c: torch.cuda.max_memory_allocated(c) for c in cards})
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dec.scan(costs[:, :frames], valid[:, :frames], minimal=minimal,
                     **kw)
            sync()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev_us = sum(e.self_device_time_total for e in rows)
        host = _host_launches(prof)
        r.update(device_ms_per_frame=dev_us / frames / 1e3,
                 busy=dev_us / 1e6 / wall,
                 profiled_wall_ms_per_frame=wall / frames * 1e3,
                 device_launches_per_frame=sum(e.count for e in rows)
                 / frames,
                 host_launches_per_frame=sum(host.values()) / frames,
                 host_launches=host)
        out[mode] = r
        log(f"scan {mode}, B={batch}, "
            f"{'minimal' if minimal else 'full'} records, {T} frames: wall "
            f"{[round(x, 3) for x in ms]} ms per frame; over {frames} "
            f"profiled frames {r['device_ms_per_frame']:.3f} ms of device "
            f"time per frame, busy {r['busy']:.3f}, "
            f"{r['device_launches_per_frame']:.2f} device and "
            f"{r['host_launches_per_frame']:.2f} host launches per frame; "
            f"peak {r['peak_alloc_bytes'] / 2**30:.2f} GiB allocated, "
            f"{r['peak_reserved_bytes'] / 2**30:.2f} GiB reserved"
            + (f"; allocated by card {_gib(r['peak_alloc_bytes_by_card'])}"
               if len(cards) > 1 else ""))
    return out


def _gib(by_card):
    """{card: bytes} as {card: GiB}, rounded to 3 places."""
    return {c: round(b / 2**30, 3) for c, b in by_card.items()}


def split_scan_modes(dec, group, fe, log=print):
    """`scan_modes` of `dec` split over the "model" group `group` and of
    `dec` unsplit, in turn, in one call: the split scan through its
    graph and stepped eagerly beside the unsplit graph (and eager
    step)."""
    what = "+".join(str(d) for d in group)
    log(f"scan_modes, split over {what}:")
    split = scan_modes(dec.shard(group), fe, log)
    log("scan_modes, unsplit:")
    res = dict(group=[str(d) for d in group], split=split,
               unsplit=scan_modes(dec, fe, log))
    g, u = split["graph"], res["unsplit"]["graph"]
    log(f"split over {what} through the graph: "
        f"{min(g['wall_ms_per_frame']):.3f}-"
        f"{max(g['wall_ms_per_frame']):.3f} ms per frame (unsplit "
        f"{min(u['wall_ms_per_frame']):.3f}-"
        f"{max(u['wall_ms_per_frame']):.3f}), device "
        f"{g['device_ms_per_frame']:.3f} ms ({u['device_ms_per_frame']:.3f}),"
        f" busy {g['busy']:.3f} ({u['busy']:.3f}), host launches "
        f"{g['host_launches_per_frame']:.2f} per frame "
        f"({u['host_launches_per_frame']:.2f}; eager split "
        f"{split['eager']['host_launches_per_frame']:.2f})")
    return res


def pcm_batch(seeds, seconds):
    from pocketsphinx_tpu_torch.testing import synth
    pcms = [synth.make_pcm(s, sec) for s, sec in zip(seeds, seconds)]
    n = max(len(p) for p in pcms)
    out = np.zeros((len(pcms), n), np.float32)
    for i, p in enumerate(pcms):
        out[i, :len(p)] = p
    return out, np.array([len(p) for p in pcms], np.int32)


def features(fe, pcm, n_samps, device):
    from pocketsphinx_tpu_torch.frontend.feat import compute_feats
    cep, nf = fe.process_batch(pcm, n_samps, device=device)
    return compute_feats(cep, nf), nf


def main_path(dec, fe, device, n_single=3, batch=8, repeats=3,
              check_cpu=True, log=print):
    """Drive the port's main path: `n_single` utterances through
    `decode`, then one B=`batch` batch through `decode_batch` `repeats`
    times (the spread of its time).  Returns a dict of what it measured
    and counts the kernels' launches over exactly this run."""
    import torch
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores

    cuda = torch.device(device).type == "cuda"
    ch = dec.CHUNK
    reset_counts()
    frames = 0
    res = {"utts": []}
    first = None
    for i in range(n_single):
        pcm, ns = pcm_batch([1 + i], [2.0 + 1.5 * i])
        feats, nf = features(fe, pcm, ns, device)
        T = int(nf[0])
        if i == 0:
            costs = senone_scores(dec.am.scoring_tensors(dec.device),
                                  feats[:, :T])[0]
            hyp, segs = dec.decode(None, costs=costs)
            first = (costs, dec.raw_records, hyp, segs, dec.hyp_score)
        else:
            hyp, segs = dec.decode(feats[0, :T])
        if not np.isfinite(dec.hyp_score):
            raise AssertionError(f"utterance {i}: hyp_score {dec.hyp_score}")
        res["utts"].append({"frames": T, "hyp": hyp, "n_segs": len(segs),
                            "hyp_score": dec.hyp_score})
        frames += -(-T // ch) * ch
    pcm, ns = pcm_batch(list(range(10, 10 + batch)),
                        list(np.linspace(2.0, 5.0, batch)))
    audio_s = float(ns.sum()) / fe.samprate
    _reset_peak(device)
    runs = []
    for _ in range(repeats):
        t0 = _sync(device)
        feats, nf = features(fe, pcm, ns, device)
        t1 = _sync(device)
        timings = {}
        out = dec.decode_batch(feats, nf, keep_records=False,
                               timings=timings)
        t2 = _sync(device)
        frames += -(-feats.shape[1] // ch) * ch
        runs.append(dict(frontend=t1 - t0, **timings, seconds=t2 - t0,
                         audio_s_per_s=audio_s / (t2 - t0)))
        if not all(np.isfinite(dec.hyp_scores)):
            raise AssertionError(f"batch hyp scores {dec.hyp_scores}")
        hyps = [h for h, _ in out]
        if runs[0].setdefault("hyps", hyps) != hyps:
            raise AssertionError("repeated batch decode changed its result")
    hyps = runs[0].pop("hyps")
    res["launches"] = counts()
    if cuda:
        want = dict.fromkeys(KERNELS, frames)
        if res["launches"] != want:
            raise AssertionError(f"launch counts {res['launches']} != "
                                 f"expected {want}")
        res["peak_mem_bytes"] = _peak(device)
    # the batch (unequal lengths) through the graph and stepped eagerly
    costs = senone_scores(dec.scoring(), feats, time_chunk=16)
    res["graph_check"] = graph_vs_eager(dec, costs, nf, "phase 5 (20k)", log)
    rates = sorted(r["audio_s_per_s"] for r in runs)
    res["batch"] = {"B": batch, "audio_s": audio_s, "frames": int(nf.max()),
                    "runs": runs, "audio_s_per_s": rates[len(rates) // 2],
                    "hyps": hyps,
                    "guard_violations": dec.guard_violations}
    if check_cpu:
        res["cpu_check"] = check_cpu_equal(dec, *first, device)
    return res


def _lattice_lists(lat):
    return ([(n.word, n.sf, n.id) for n in lat.nodes],
            [(l.src, l.dst, l.ef, l.ascr) for l in lat.links],
            (lat.start, lat.end))


def facade(work, device, log=print, seconds=(2.0, 3.0), stream_seconds=3.0,
           dic=None, lmfile=None, n_sen=None, n_density=None, hold=None):
    """Phase 7: the port's `Decoder` on `device` over a synthetic model
    directory written under `work` (en-us shapes unless `n_sen` /
    `n_density` say otherwise) with `dic` and `lmfile` (default the 20k
    task).  (a) `decode_raw` of one seeded utterance per entry of
    `seconds`; (b) `stream_seconds` of seeded PCM streamed in 0.1 s
    chunks; (c) launch counts over (a) and (b); then the checks against
    the CPU and the whole-utterance scan.  Returns what it measured; a
    dict passed as `hold` receives the decoder (key "decoder") and its CMN
    state as built (key "cmn0")."""
    import copy
    import torch
    from pocketsphinx_tpu_torch import Decoder
    from pocketsphinx_tpu_torch.testing import synth

    dic = dic or os.path.join(BENCH, "bench-20k.dic")
    lmfile = lmfile or os.path.join(BENCH, "bench-20k.lm.bin")
    kw = {k: v for k, v in (("n_sen", n_sen), ("n_density", n_density))
          if v is not None}
    t0 = time.perf_counter()
    hmm = synth.make_model([dic], seed=0, **kw).write_model_dir(
        os.path.join(work, "hmm"))
    dec = Decoder(hmm=hmm, dict=dic, lm=lmfile, device=device)
    cmn0 = copy.deepcopy(dec.cmn_state)
    search = dec._searches["_default"]
    ch = search.CHUNK
    log(f"facade: Decoder(hmm=<synthetic>, dict={os.path.basename(dic)}, "
        f"lm={os.path.basename(lmfile)}) on {dec.device}: W={search.W}, "
        f"LM mode {search.lm_mode}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    # the best-path pass looks up LM entries through host maps built on
    # first use; build them here, timed on their own, so that no
    # utterance's bestpath seconds include them
    t0 = time.perf_counter()
    for level in range(1, search.lm.order):
        search.lm._level_map(level)
    res = {"utts": [], "lm_maps_s": time.perf_counter() - t0}
    log(f"facade: LM host maps built in {res['lm_maps_s']:.4f} s")
    reset_counts()
    frames = 0
    for i, sec in enumerate(seconds):                      # (a)
        h = dec.decode_raw(synth.make_pcm(100 + i, sec))
        T = dec.n_frames
        frames += -(-T // ch) * ch
        lat = dec.get_lattice()
        u = dict(frames=T, hyp=h.hypstr, score=h.score, prob=h.prob,
                 n_segs=len(list(dec.seg_iter())),
                 nodes=lat.n_nodes if lat else 0,
                 links=lat.n_links if lat else 0,
                 **{k + "_s": t.t_elapsed
                    for k, t in dec.stage_timers.items()})
        if not (np.isfinite(h.score) and 0.0 < h.prob <= 1.0 and lat):
            raise AssertionError(f"decode_raw {i}: {u}")
        log(f"facade decode_raw {i}: " + json.dumps(u))
        res["utts"].append(u)
        if i == 0:
            first = (dec._feats, search.raw_records, _lattice_lists(lat),
                     (h.hypstr, h.score, h.prob),
                     [(s.word, s.start_frame, s.end_frame)
                      for s in dec.seg_iter()])
    pcm = synth.make_pcm(200, stream_seconds)              # (b)
    step = dec.fe.samprate // 10
    # keep each streamed block's cost matrix for the whole-utterance
    # check: the hook holds a reference, with no copy and no sync, so the
    # block times stay what a live user waits for
    stream_costs, scores = [], dec._scores

    def keep(feats, **kw):
        stream_costs.append(scores(feats, **kw))
        return stream_costs[-1]

    dec._scores = keep
    dec.start_utt()
    partials = []
    for c0 in range(0, len(pcm), step):
        dec.process_raw(pcm[c0:c0 + step])
        h = dec.partial_hyp()
        partials.append(h.hypstr if h else None)
    t0 = dec._sync()
    dec.end_utt()
    end_s = dec._sync() - t0
    dec._scores = scores
    blocks = dec.stream_block_seconds
    frames += 32 * len(blocks)
    res["launches"] = counts()
    if torch.device(device).type == "cuda":                 # (c)
        want = dict.fromkeys(KERNELS, frames)
        if res["launches"] != want:
            raise AssertionError(f"facade launch counts {res['launches']} "
                                 f"!= frames stepped {want}")
    lat = dec.get_lattice()
    res["stream"] = dict(
        frames=dec.n_frames, blocks=len(blocks),
        block_ms_median=float(np.median(blocks)) * 1e3,
        block_ms_max=float(np.max(blocks)) * 1e3,
        end_utt_s=end_s, hyp=dec.hyp().hypstr, partials=partials[-3:],
        nodes=lat.n_nodes if lat else 0, links=lat.n_links if lat else 0)
    log("facade stream: " + json.dumps(res["stream"]))
    # (b) check: the streamed records == one scan of the same costs
    T = dec.n_frames
    if len(stream_costs) != len(blocks):
        raise AssertionError(f"{len(stream_costs)} cost blocks kept for "
                             f"{len(blocks)} streamed blocks")
    costs = torch.cat(stream_costs)[None, :T]     # only the last is padded
    t0 = dec._sync()
    whole = search.scan(costs, torch.ones((1, T), dtype=torch.bool,
                                          device=search.device))
    whole_s = dec._sync() - t0
    names = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
    for k, (n, w) in enumerate(zip(names, whole)):
        got = np.concatenate([r[k] for r in dec._stream_recs])
        if not np.array_equal(got, w[0, :T].cpu().numpy()):
            raise AssertionError(f"streamed records differ from the whole "
                                 f"scan: {n}")
    # (a) check: the same decoder on the CPU, same cost matrix
    feats, raw, lists, hyp, segs = first
    costs = dec._scores(feats)
    cpu = dec._to("cpu")
    t0 = time.perf_counter()
    cpu.decode_senscr(costs.cpu().numpy())
    cpu_s = time.perf_counter() - t0
    for n, a, b in zip(names, raw, cpu._searches["_default"].raw_records):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"facade {device} vs cpu records: {n}")
    h = cpu.hyp()
    if (_lattice_lists(cpu.get_lattice()) != lists
            or (h.hypstr, h.score, h.prob) != hyp
            or [(s.word, s.start_frame, s.end_frame)
                for s in cpu.seg_iter()] != segs):
        raise AssertionError(f"facade {device} vs cpu lattice or best path "
                             f"differ: {hyp} / {(h.hypstr, h.score, h.prob)}")
    res["cpu_check"] = dict(frames=int(costs.shape[0]), seconds=cpu_s,
                            equal=True)
    res["stream_check"] = dict(frames=T, equal=True, whole_scan_s=whole_s)
    res["graph_check"] = stream_graph_check(dec, pcm, stream_costs, partials,
                                            cpu, log)
    if hold is not None:
        hold.update(decoder=dec, cmn0=cmn0)
    return res


def stream_graph_check(dec, pcm, stream_costs, partials, cpu, log=print,
                       t0=37, n=80):
    """Phase 7(d): `dec`'s stream of `pcm` (0.1 s chunks, its blocks'
    costs `stream_costs`, its partial hypotheses `partials`) stepped
    eagerly by a twin (`Decoder._to(..., graph=False)`) fed the same
    costs: the same records, partial and final hypotheses; then the
    first `n` frames of those costs through `with_carry` in two blocks,
    the second resumed at frame `t0` (not a multiple of CHUNK) from the
    first one's carry, through the graph, stepped eagerly and on the
    CPU twin `cpu`: the same records and carry."""
    import torch
    t_start = time.perf_counter()
    search = dec._searches["_default"]
    eager = dec._to(dec.device, graph=False)
    blocks = iter(stream_costs)
    eager._scores = lambda feats, **kw: next(blocks)
    eager.start_utt()
    step = dec.fe.samprate // 10
    got = []
    for c0 in range(0, len(pcm), step):
        eager.process_raw(pcm[c0:c0 + step])
        h = eager.partial_hyp()
        got.append(h.hypstr if h else None)
    eager.end_utt()
    if len(eager.stream_block_seconds) != len(stream_costs):
        raise AssertionError("the eager stream stepped another number of "
                             "blocks")
    for k in range(10):
        a, b = (np.concatenate([r[k] for r in d._stream_recs])
                for d in (dec, eager))
        if not np.array_equal(a, b):
            raise AssertionError(f"stream record {k}: graph != eager")
    if got != partials or eager.hyp().hypstr != dec.hyp().hypstr:
        raise AssertionError("stream hypotheses: graph != eager")
    del eager
    costs = torch.cat(stream_costs)[None, :n]
    runs = []
    for s, g in ((search, True), (search, False),
                 (cpu._searches["_default"], None)):
        c = costs.to(s.device)
        v = torch.ones((1, n), dtype=torch.bool, device=s.device)
        r1, k1 = s.with_carry(c[:, :t0], v[:, :t0], graph=g)
        r2, k2 = s.with_carry(c[:, t0:], v[:, t0:], k1, t0, graph=g)
        runs.append([x.cpu() for x in r1 + r2]
                    + [x.cpu() for _, x in s._carry_fields(k2)])
    for what, other in (("eager", runs[1]), ("the CPU", runs[2])):
        for i, (a, b) in enumerate(zip(runs[0], other, strict=True)):
            if not torch.equal(a, b):
                raise AssertionError(f"with_carry resumed at {t0}: graph != "
                                     f"{what} (output {i})")
    res = dict(blocks=len(stream_costs), hyp=dec.hyp().hypstr,
               resumed_at=t0, frames=n, equal=True,
               seconds=time.perf_counter() - t_start)
    log("phase 7(d) stream: graph == eager, and resumed at frame "
        f"{t0}: graph == eager == cpu: " + json.dumps(res))
    return res


#: phase 8's search modes (`add_mode`)
MODES = ("jsgf", "kws", "allphone", "allphone_tri", "align")
#: each mode's utterance length (s), and the 5-state decode's
SECONDS = dict(jsgf=3.0, kws=5.0, allphone=3.0, allphone_tri=3.0, align=5.0)
SECONDS5 = 2.0


def mode_decoder(work, device, hmm=None, dic=None):
    """A `Decoder` without a search on `device`, over the model directory
    `hmm` and dictionary `dic`, or over a small task written under
    `work`."""
    from pocketsphinx_tpu_torch import Decoder
    from pocketsphinx_tpu_torch.testing import synth
    if hmm is None:
        hmm, dic, _ = synth.small_task(work, seed=7)
    return Decoder(hmm=hmm, dict=dic, device=device)


def add_mode(dec, mode, work, seed=0, sizes=(6, 12, 4), n_kws=8,
             n_align=7):
    """Add the search of `mode` (one of `MODES`) to `dec`, from seeded
    files written under `work`: a command grammar whose rules hold
    `sizes` words, `n_kws` keyphrases, a phone-bigram LM (CI allphone;
    the triphone net runs without one), `n_align` words to align.
    Returns the search's name."""
    from pocketsphinx_tpu_torch.testing import synth
    dic = dec.config["dict"]
    at = lambda name: os.path.join(work, name)  # noqa: E731
    if mode == "jsgf":
        dec.add_jsgf(mode, synth.write_jsgf(dic, at("cmd.gram"), seed=seed,
                                            sizes=sizes))
    elif mode == "kws":
        dec.add_kws(mode, synth.write_keyphrases(dic, at("k.txt"), seed=seed,
                                                 n=n_kws))
    elif mode in ("allphone", "allphone_tri"):
        ci = dec.config["allphone_ci"]
        dec.config["allphone_ci"] = mode == "allphone"
        try:
            dec.add_allphone(mode, synth.write_phone_arpa(
                at("phone.arpa"), seed=seed) if mode == "allphone" else None)
        finally:
            dec.config["allphone_ci"] = ci
    elif mode == "align":
        words = synth.grammar_words(dic)
        pick = np.random.default_rng(seed).choice(len(words), n_align)
        dec.add_align_text(" ".join(words[i] for i in pick))
        return "_align"
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return mode


def mode_size(search):
    """The size of a search's network: A grammar arcs, P HMM rows, N
    allphone nodes, NK keyphrases (an aligner's P after its `align`)."""
    kind = type(search).__name__
    if kind == "FsgDecoder":
        return {"A": search.A, "P": search.P}
    if kind == "KwsDecoder":
        NK, K = search.kw_senid.shape[:2]
        return {"NK": NK, "P": len(search.bg_senid) + NK * K}
    if kind == "AllphoneDecoder":
        return {"N": search.n_node}
    return {"P": int(search.records[4].shape[1])}


def check_records(a, b, what):
    """Two searches' per-frame records (`records`: host arrays) are
    bit-equal, dtypes and shapes included."""
    for i, (x, y) in enumerate(zip(a.records, b.records)):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(
                x, y):
            raise AssertionError(f"{what}: records {i} differ")


def mode_result(dec):
    """A decode's result through the facade in any mode: hypothesis,
    segments, lattice lists and alignment entries."""
    from dataclasses import astuple
    lat = dec.get_lattice()
    al = (dec.get_alignment() if type(dec._searches[dec._active]).__name__
          == "Aligner" else None)
    return (astuple(dec.hyp()),
            [(s.word, s.start_frame, s.end_frame, s.ascore, s.prob)
             for s in dec.seg_iter()],
            None if lat is None else _lattice_lists(lat),
            None if al is None else [[astuple(e) for e in lv] for lv in al])


def modes(work, device, log=print, hmm=None, dic=None, lmfile=None,
          n_sen=None, n_density=None, n_sen5=None, sizes=(200, 1000, 100),
          n_kws=20, n_align=40, dec3=None):
    """Phase 8: the grammar, keyword, allphone and align searches and a
    5-state n-gram decode through the `Decoder` on `device` (see the
    module docstring), over the model directory `hmm` (else a synthetic
    one written under `work`, en-us shapes unless `n_sen` / `n_density`
    say otherwise) with `dic` and, for the 5-state model (`n_sen5`
    senones), `lmfile` (default the 20k task).  With `dec3`, a 3-state
    n-gram `Decoder` over the same task, the 5-state utterance is decoded
    by the two in turns (3, 5, 5, 3, 3, 5), which compares their search
    ms per frame on one host at one time.  Returns what it measured."""
    import torch
    from pocketsphinx_tpu_torch import Decoder
    from pocketsphinx_tpu_torch.testing import synth

    dic = dic or os.path.join(BENCH, "bench-20k.dic")
    lmfile = lmfile or os.path.join(BENCH, "bench-20k.lm.bin")
    kw = {k: v for k, v in (("n_density", n_density),) if v is not None}
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    if hmm is None:
        hmm = synth.make_model([dic], seed=0, **kw, **(
            {"n_sen": n_sen} if n_sen else {})).write_model_dir(
                os.path.join(work, "hmm"))
    dec = mode_decoder(work, device, hmm=hmm, dic=dic)
    dec.am.scoring_tensors(dec.device)      # uploaded once, not in a mode
    res = {"decoder_s": time.perf_counter() - t0, "modes": {}}
    kept = []
    for i, mode in enumerate(MODES):
        t0 = time.perf_counter()
        name = add_mode(dec, mode, work, seed=i, sizes=sizes, n_kws=n_kws,
                        n_align=n_align)
        build_s = time.perf_counter() - t0
        search = dec._searches[name]
        dec.activate_search(name)
        dec.decode_raw(synth.make_pcm(300 + i, SECONDS[mode]))
        T = dec.n_frames
        st = {k: t.t_elapsed for k, t in dec.stage_timers.items()}
        u = dict(frames=T, hyp=dec.hyp().hypstr[:80], build_s=build_s,
                 **mode_size(search), search_s=st["search"],
                 ms_per_frame=st["search"] / T * 1e3,
                 bestpath_s=st["bestpath"])
        log(f"modes {mode}: " + json.dumps(u))
        res["modes"][mode] = u
        kept.append((mode, name, dec._feats, mode_result(dec)))
    # each mode's CUDA result == the same decoder on the CPU, same costs
    t0 = time.perf_counter()
    cpu = dec._to("cpu")
    for mode, name, feats, result in kept:
        cpu.activate_search(name)
        cpu.decode_senscr(dec._scores(feats).cpu().numpy())
        check_records(dec._searches[name], cpu._searches[name],
                      f"{mode} {device} vs cpu")
        if mode_result(cpu) != result:
            raise AssertionError(f"{mode} {device} vs cpu result differs: "
                                 f"{result[0]} / {mode_result(cpu)[0]}")
    res["cpu_check_s"] = time.perf_counter() - t0
    log(f"modes: {device} results equal the CPU's "
        f"({res['cpu_check_s']:.1f} s)")
    if cuda:
        g = res["modes"]["jsgf"]
        res["exit_block"] = exit_block_ms(
            (g["A"], 2500, 5000, 10000, 20000), g["P"] / g["A"], log)
    del dec, cpu

    # (e) 5-state models through the n-gram search
    t0 = time.perf_counter()
    hmm5 = synth.make_model([dic], seed=0, n_state=5, **kw, **(
        {"n_sen": n_sen5} if n_sen5 else {})).write_model_dir(
            os.path.join(work, "hmm5"))
    dec5 = Decoder(hmm=hmm5, dict=dic, lm=lmfile, device=device)
    s5 = dec5._searches["_default"]
    log(f"5-state decoder: W={s5.W}, NST={s5.NST}, LM mode {s5.lm_mode}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    if s5.NST != 5:
        raise AssertionError(f"5-state model has NST={s5.NST}")
    if cuda:
        # at the decode's batch (B=1), and at phase 3's B=8
        res["chain5"] = {B: check_chain(B, buckets_of(s5), log)
                         for B in (1, 8)}
    for level in range(1, s5.lm.order):      # the best-path LM maps
        s5.lm._level_map(level)
    reset_counts()
    pcm5 = synth.make_pcm(400, SECONDS5)
    h = dec5.decode_raw(pcm5)
    T = dec5.n_frames
    frames = -(-T // s5.CHUNK) * s5.CHUNK
    launches = counts()
    if cuda and launches != {"fan": 0, "chain": frames,
                             "transitions": frames}:
        raise AssertionError(f"5-state launches {launches} != fan 0, chain "
                             f"and transitions {frames} (frames stepped)")
    st = {k: t.t_elapsed for k, t in dec5.stage_timers.items()}
    res["nst5"] = dict(frames=T, hyp=h.hypstr, launches=launches,
                       search_s=st["search"],
                       ms_per_frame=st["search"] / T * 1e3,
                       bestpath_s=st["bestpath"])
    log("5-state decode_raw: " + json.dumps(res["nst5"]))
    raw, result, feats5 = s5.raw_records, mode_result(dec5), dec5._feats
    if dec3 is not None:
        turns = []
        for nst in (3, 5, 5, 3, 3, 5):
            d = dec5 if nst == 5 else dec3
            d.decode_raw(pcm5)
            turns.append((nst, d.stage_timers["search"].t_elapsed
                          / d.n_frames * 1e3))
        res["nst_turns"] = turns
        log("3- and 5-state search ms per frame in turns: "
            + json.dumps(turns))
    cpu5 = dec5._to("cpu")
    cpu5.decode_senscr(dec5._scores(feats5).cpu().numpy())
    names = "escore etf etgt ecx entry eprw erw1 erw2 m nviol".split()
    for n, a, b in zip(names, raw, cpu5._searches["_default"].raw_records):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"5-state {device} vs cpu records: {n}")
    if mode_result(cpu5) != result:
        raise AssertionError(f"5-state {device} vs cpu result differs: "
                             f"{result[0]} / {mode_result(cpu5)[0]}")
    return res


def _results(out):
    """[(hyp, segs)] as comparable tuples."""
    return [(h, seg_key(segs)) for h, segs in out]


def reference_decoder(work, device, lmfile=None, base_dic=None, n_sen=None,
                      n_density=None):
    """Phase 9's task: `lmfile` (default bench-135k.lm.bin) over
    `synth.dictionary_for_lm` of its vocabulary with `base_dic`'s
    pronunciations (default bench-20k.dic) and a synthetic en-us-shaped
    model over that dictionary, on `device`.  Returns (decoder, the
    seconds of the model, the LM read and the decoder build)."""
    from pocketsphinx_tpu_torch.fileio.dictionary import Dictionary
    from pocketsphinx_tpu_torch.lm.ngram import read_lm
    from pocketsphinx_tpu_torch.models.dict2pid import Dict2Pid
    from pocketsphinx_tpu_torch.search.ngram_fused import NgramFusedDecoder
    from pocketsphinx_tpu_torch.testing import synth

    lmfile = lmfile or os.path.join(BENCH, "bench-135k.lm.bin")
    base_dic = base_dic or os.path.join(BENCH, "bench-20k.dic")
    kw = {k: v for k, v in (("n_sen", n_sen), ("n_density", n_density))
          if v is not None}
    res = {}
    t0 = time.perf_counter()
    dic = synth.dictionary_for_lm(lmfile, base_dic,
                                  os.path.join(work, "lm_vocab.dic"))
    am, noise = synth.make_model([dic], seed=0, **kw).load(
        os.path.join(work, "model_lm_vocab"))
    d2p = Dict2Pid(am.mdef, Dictionary(am.mdef, dic, noise))
    res["model_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = read_lm(lmfile, lw=6.5, wip=0.65)
    res["lm_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = NgramFusedDecoder(am, d2p, lm, device=device)
    res["build_s"] = _sync(device) - t0
    return dec, res


def reference_utterances(batch=8):
    """Phase 9(b)'s utterances: 2 * `batch` seeded ones of 2-5 s."""
    from pocketsphinx_tpu_torch.testing import synth
    return [synth.make_pcm(500 + i, s)
            for i, s in enumerate(np.linspace(2.0, 5.0, 2 * batch))]


def reference_scale(work, device, log=print, lmfile=None, base_dic=None,
                    n_sen=None, n_density=None, seconds=None, batch=8,
                    repeats=3, check_seconds=1.0, profile=False, hold=None):
    """Phase 9 (a)-(c): the 126k-word task, `lmfile` (default
    bench-135k.lm.bin) over `synth.dictionary_for_lm` of its vocabulary
    with `base_dic`'s pronunciations (default bench-20k.dic), a synthetic
    en-us-shaped model over that dictionary (unless `n_sen` / `n_density`
    say otherwise), on `device`.  (a) the LM read and decoder build
    seconds, LM mode C (asserted), the shapes, and on CUDA both kernels
    held to their plain versions at this decoder's shapes; (b)
    `BatchDecodePipeline.decode_corpus` on one card of seeded utterances of
    `seconds` (default 16 of 2-5 s: two B=`batch` batches) `repeats`
    times: audio-s/s, stage seconds, peak memory, guard count, launches ==
    frames stepped; then one `check_seconds` utterance decoded on
    `device` and by the decoder moved to the CPU from one cost matrix,
    records equal; (c) `TwoStagePipeline` over the same utterances, equal
    to (b).  With `profile` (CUDA), `profile_scan` of this decoder after
    (a).  A dict passed as `hold` receives the decoder, the utterances,
    (b)'s first result, its guard count and its median scan ms per frame
    (phase 11's reference).  Returns what it measured."""
    import torch
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
    from pocketsphinx_tpu_torch.parallel.pipeline import TwoStagePipeline
    from pocketsphinx_tpu_torch.testing import synth

    cuda = torch.device(device).type == "cuda"
    # (a) the task and its decoder
    dec, res = reference_decoder(work, device, lmfile, base_dic, n_sen,
                                 n_density)
    if dec.lm_mode != "csr":
        raise AssertionError(f"LM mode {dec.lm_mode} != csr at V={dec.V}")
    res["shape"] = dict(V=int(dec.V), W=dec.W, n_multi=dec.n_multi,
                        E=dec.nE, n_rc=dec.n_rcp, n_fat=dec.N_FAT,
                        SB=dec.SB, S_TRI=dec.S_TRI,
                        chain_buckets=[(c.D, c.Wb, c.RF) for c in dec.chains],
                        ci_buckets=[(c.D, c.Wb) for c in dec.ci_chains])
    log(f"reference scale: dictionary and model {res['model_s']:.1f} s, LM "
        f"read {res['lm_read_s']:.1f} s, decoder built (host tables and "
        f"upload) {res['build_s']:.1f} s; LM mode {dec.lm_mode}: "
        + json.dumps(res["shape"]))
    fe = en_us_frontend()
    if cuda:
        res["fan"] = check_fan(batch, dec.n_rcp, dec.n_multi,
                               dec.senid_fin_d.shape[-1], log)
        res["chain"] = check_chain(batch, buckets_of(dec), log)
        res["transitions"] = check_transitions(dec, fe, log, batch=batch)
        if profile:
            res["profile"] = profile_scan(dec, fe, log, batch=batch)
            res["modes"] = scan_modes(dec, fe, log, batch=batch)

    # (b) the corpus pipeline
    pcms = (reference_utterances(batch) if seconds is None else
            [synth.make_pcm(500 + i, s) for i, s in enumerate(seconds)])
    audio_s = sum(len(p) for p in pcms) / fe.samprate
    lens = sorted(len(p) for p in pcms)
    ch = dec.CHUNK
    frames = sum(-(-fe.n_frames(max(lens[i:i + batch])) // ch) * ch
                 for i in range(0, len(lens), batch))
    pipe = BatchDecodePipeline(dec, fe, mesh=make_mesh(1, device=dec.device))
    reset_counts()
    _reset_peak(device)
    runs, first = [], None
    for _ in range(repeats):
        st = {}
        t0 = _sync(device)
        out = _results(pipe.decode_corpus(pcms, batch_size=batch,
                                          timings=st))
        dt = _sync(device) - t0
        runs.append(dict(seconds=dt, audio_s_per_s=audio_s / dt,
                         scan_ms_per_frame=st["scan"] / frames * 1e3,
                         guard_violations=pipe.guard_violations, **st))
        if first is None:
            first = out
        elif out != first:
            raise AssertionError("repeated decode_corpus changed its result")
    launches = counts()
    if cuda and launches != dict.fromkeys(KERNELS, frames * repeats):
        raise AssertionError(f"decode_corpus launches {launches} != frames "
                             f"stepped {frames * repeats}")
    med = sorted(runs, key=lambda r: r["audio_s_per_s"])[len(runs) // 2]
    res["corpus"] = dict(
        utts=len(pcms), audio_s=audio_s, frames_per_run=frames,
        launches=launches, audio_s_per_s=med["audio_s_per_s"],
        median_run=med, runs=[r["audio_s_per_s"] for r in runs],
        hyps=[h for h, _ in first][:4],
        peak_mem_bytes=_peak(device))
    log("decode_corpus: " + json.dumps(res["corpus"], default=float))
    # one batch of short utterances, the first `check_seconds` long,
    # through decode_batch's minimal records: each row equals its own B=1
    # full-record decode of the same costs; then the first row's decode
    # equals the CPU's
    t0 = time.perf_counter()
    pcm, ns = pcm_batch(list(range(600, 600 + batch)), [check_seconds] + list(
        np.linspace(0.3, 0.9, batch - 1)))
    feats, nf = features(fe, pcm, ns, device)
    costs = senone_scores(dec.am.scoring_tensors(dec.device), feats,
                          time_chunk=16)
    rows = _results(dec.decode_batch(None, nf, keep_records=False,
                                     costs=costs))
    scores = list(dec.hyp_scores)
    for b in reversed(range(batch)):
        hyp, segs = dec.decode(None, costs=costs[b, :int(nf[b])])
        if (_results([(hyp, segs)])[0], dec.hyp_score) != (rows[b],
                                                           scores[b]):
            raise AssertionError(f"B={batch} minimal records, row {b}: "
                                 f"differs from its B=1 decode")
    res["batch_check"] = dict(B=batch, frames=[int(x) for x in nf],
                              hyps=[h for h, _ in rows],
                              seconds=time.perf_counter() - t0)
    log("reference scale, minimal records at B=8 equal each row's B=1 "
        "decode: " + json.dumps(res["batch_check"]))
    res["graph_check"] = graph_vs_eager(dec, costs, nf, "phase 9 (126k)",
                                        log)
    t0 = time.perf_counter()
    res["cpu_check"] = check_cpu_equal(dec, costs[0, :int(nf[0])],
                                       dec.raw_records, hyp, segs,
                                       dec.hyp_score, device)
    res["cpu_check"]["seconds"] = time.perf_counter() - t0
    log("reference scale, one utterance on the CPU: "
        + json.dumps(res["cpu_check"]))

    # (c) the two-stage pipeline
    t0 = _sync(device)
    two = _results(TwoStagePipeline(dec, fe).decode_corpus(
        pcms, micro_batch=batch))
    res["two_stage_s"] = _sync(device) - t0
    if two != first:
        raise AssertionError("TwoStagePipeline differs from decode_corpus")
    log(f"TwoStagePipeline equals decode_corpus ({res['two_stage_s']:.1f} s)")
    if hold is not None:
        hold.update(decoder=dec, pcms=pcms, first=first,
                    guard=runs[0]["guard_violations"],
                    scan_ms_per_frame=med["scan_ms_per_frame"])
    return res


def guard_topm(dec, device, log=print, gm=64, batch=8):
    """Phase 9(d): one B=`batch` batch (phase 5's utterances) through
    `dec` and through a copy whose tables add PS_GUARD_TOPM=`gm`: every
    record but `nviol`, the hypotheses and segments equal; both guard
    counts, the BMAX table's bytes and the peak memory of each run."""
    import copy
    import torch
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores

    fe = en_us_frontend()
    pcm, ns = pcm_batch(list(range(10, 10 + batch)),
                        list(np.linspace(2.0, 5.0, batch)))
    feats, nf = features(fe, pcm, ns, device)
    costs = senone_scores(dec.am.scoring_tensors(dec.device), feats,
                          time_chunk=16)
    valid = (torch.arange(costs.shape[1], device=costs.device)[None, :]
             < torch.as_tensor(nf, device=costs.device)[:, None])
    t0 = time.perf_counter()
    with _env("PS_GUARD_TOPM", str(gm)):
        top = copy.copy(dec)
        top.host_tables = top._host_tables()
        top.tables = top.device_tables(top.host_tables, dec.device)
    res = {"build_s": time.perf_counter() - t0, "GM": top.GM,
           "bmax_bytes": int(top.host_tables["guard_bmax"].nbytes)}
    if top.GM != gm:
        raise AssertionError(f"PS_GUARD_TOPM={gm} not in effect ({top.GM})")
    runs = []
    for d in (dec, top):
        _reset_peak(device)
        recs = d.scan(costs, valid)
        out = _results(d.decode_batch(None, nf, keep_records=False,
                                      costs=costs))
        runs.append((recs, out, d.guard_violations, _peak(device)))
    (r0, o0, v0, m0), (rg, og, vg, mg) = runs
    names = "escore etf etgt ecx entry eprw erw1 erw2 m".split()
    for n, a, b in zip(names, r0, rg):
        if not torch.equal(a, b):
            raise AssertionError(f"PS_GUARD_TOPM={gm} changed record {n}")
    if o0 != og:
        raise AssertionError(f"PS_GUARD_TOPM={gm} changed the hypotheses")
    res.update(guard_violations_gm0=v0, guard_violations=vg,
               peak_mem_bytes_gm0=m0, peak_mem_bytes=mg,
               hyps=[h for h, _ in og][:4])
    log("PS_GUARD_TOPM: " + json.dumps(res))
    return res


def batch_cli(work, device, log=print, dic=None, lmfile=None, n_utts=8,
              n_sen=None, n_density=None):
    """Phase 9(e): `cli_batch.main` on `device` over a synthetic model
    directory with `dic` and `lmfile` (default the 1.7k task) and
    `n_utts` seeded WAV files (`-adcin yes`), at `-batchsize 8` and 1:
    the `-hyp` and `-hypseg` files must be identical.  Returns the
    seconds of each run and the hypotheses."""
    from pocketsphinx_tpu_torch import cli_batch
    from pocketsphinx_tpu_torch.testing import synth

    dic = dic or os.path.join(BENCH, "bench-1.7k.dic")
    lmfile = lmfile or os.path.join(BENCH, "bench-1.7k.lm.bin")
    kw = {k: v for k, v in (("n_sen", n_sen), ("n_density", n_density))
          if v is not None}
    hmm = synth.make_model([dic], seed=0, **kw).write_model_dir(
        os.path.join(work, "hmm_cli"))
    wavs = os.path.join(work, "wav")
    os.makedirs(wavs, exist_ok=True)
    ids = [f"utt{i}" for i in range(n_utts)]
    for i, (u, s) in enumerate(zip(ids, np.linspace(1.0, 3.0, n_utts))):
        _write_wav(os.path.join(wavs, u + ".wav"), synth.make_pcm(700 + i, s))
    ctl = os.path.join(work, "cli.ctl")
    with open(ctl, "w") as f:
        f.write("\n".join(ids) + "\n")
    res, outs = {}, {}
    for bs in (8, 1):
        hyp, seg = (os.path.join(work, f"b{bs}.{x}") for x in ("hyp", "seg"))
        t0 = time.perf_counter()
        rc = cli_batch.main(["-hmm", hmm, "-dict", dic, "-lm", lmfile,
                             "-ctl", ctl, "-adcin", "yes", "-cepdir", wavs,
                             "-cepext", ".wav", "-batchsize", str(bs),
                             "-hyp", hyp, "-hypseg", seg], device=device)
        res[f"batchsize_{bs}_s"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli_batch -batchsize {bs} exited {rc}")
        outs[bs] = tuple(open(p).read() for p in (hyp, seg))
    if outs[8] != outs[1]:
        raise AssertionError("cli_batch output depends on -batchsize")
    res["hyps"] = outs[8][0].splitlines()[:4]
    log("cli_batch: -batchsize 8 and 1 give identical -hyp and -hypseg: "
        + json.dumps(res))
    return res


def rows_transitions(work, log=print, device="cuda"):
    """Phase 9(e'): the word-transition kernel in LM mode rows, on a
    decoder of bench-1.7k.dic and bench-1.7k.lm.bin over a seeded
    synthetic en-us-shaped model (files under `work`/rows_1k7):
    `check_transitions` at its shapes."""
    t0 = time.perf_counter()
    d = os.path.join(work, "rows_1k7")
    os.makedirs(d, exist_ok=True)
    dec, fe = build_decoder(os.path.join(BENCH, "bench-1.7k.dic"),
                            os.path.join(BENCH, "bench-1.7k.lm.bin"), d,
                            device)
    if dec.lm_mode != "rows":
        raise AssertionError(f"1.7k LM mode {dec.lm_mode} != rows")
    build_s = time.perf_counter() - t0
    res = check_transitions(dec, fe, log)
    res["build_s"] = build_s
    log(f"phase 9(e') transitions at 1.7k, LM mode rows: "
        + json.dumps(res, default=float))
    return res


# ---------------------------------------------------------------------------
# phase 10: the CLI, the compat API, the flat search, top-K exactness
# ---------------------------------------------------------------------------

# the seeded bursts (`synth.bursts_pcm`) that `live` reads at both widths
LIVE_SEED, LIVE_SECONDS = 301, 8.0


def run_cli(argv, device):
    """`cli.main(argv, device=device)` in-process: (its stdout lines, its
    seconds, the kernels' launches during it).  Raises unless it exits 0."""
    import gc
    import io
    from pocketsphinx_tpu_torch import cli

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, device=device)
    secs = time.perf_counter() - t0
    gc.collect()                    # the CLI's decoder and its tables
    if rc != 0:
        raise AssertionError(f"cli {argv[-2:]} exited {rc}")
    return out.getvalue().splitlines(), secs, counts()


def cli_20k(work, device, log=print, hmm=None, dic=None, lmfile=None,
            dec=None, cmn0=None):
    """Phase 10(a): the `pocketsphinx-tpu-torch` program in-process on
    `device` over the model directory `hmm` with `dic` and `lmfile`
    (default the 20k task): `single` on a seeded 2 s WAV and `live` over
    `LIVE_SECONDS` of seeded bursts (`synth.bursts_pcm`), each command
    building its own `Decoder`; then one `Decoder` (`dec` over the same
    files, its CMN state set back to `cmn0`, the state it was built with;
    else one built here) decodes the same PCM (`single`'s utterance
    through `decode_raw`, then each VAD segment streamed through
    `process_raw` from that CMN state, as `live` does), and every JSON
    line must equal the CLI's; the kernels' launches during each command
    must equal the frames it stepped.  Returns (what it measured, the
    decoder)."""
    import copy
    from pocketsphinx_tpu_torch import Decoder, cli
    from pocketsphinx_tpu_torch.testing import synth
    from pocketsphinx_tpu_torch.vad import Endpointer

    dic = dic or os.path.join(BENCH, "bench-20k.dic")
    lmfile = lmfile or os.path.join(BENCH, "bench-20k.lm.bin")
    cuda = device != "cpu"
    pcm1 = synth.make_pcm(300, 2.0)
    pcm2 = synth.bursts_pcm(LIVE_SEED, LIVE_SECONDS)
    w1 = _write_wav(os.path.join(work, "cli_single.wav"), pcm1)
    w2 = _write_wav(os.path.join(work, "cli_live.wav"), pcm2)
    base = ["-hmm", hmm, "-dict", dic, "-lm", lmfile]
    single, single_secs, single_l = run_cli(base + ["single", w1], device)
    live, live_secs, live_l = run_cli(base + ["live", w2], device)
    t0 = time.perf_counter()
    if dec is None:
        dec = Decoder(hmm=hmm, dict=dic, lm=lmfile, device=device)
        cmn0 = copy.deepcopy(dec.cmn_state)
    build_s = time.perf_counter() - t0
    ch = dec._searches["_default"].CHUNK
    dec.cmn_state = copy.deepcopy(cmn0)
    dec.decode_raw(pcm1)
    want = [json.dumps(cli.hyp_doc(dec))]
    frames = -(-dec.n_frames // ch) * ch
    if single != want:
        raise AssertionError(f"cli single {single} != decode_raw {want}")
    if cuda and single_l != dict.fromkeys(KERNELS, frames):
        raise AssertionError(f"cli single launches {single_l} != frames "
                             f"stepped {frames}")
    segs = list(Endpointer(sample_rate=dec.fe.samprate).segment(pcm2))
    if len(segs) < 2:
        raise AssertionError(f"the VAD found {len(segs)} segments")
    # `live` streams each segment (live CMN inside the utterance); so does
    # the reference here.  `decode_raw` of a segment normalizes it as a
    # whole, so its words may differ: counted, not required.
    want, raw_docs, frames_l = [], [], 0
    for stream in (True, False):
        dec.cmn_state = copy.deepcopy(cmn0)
        for start, end, speech in segs:
            if stream:
                dec.start_utt()
                dec.process_raw(speech)
                dec.end_utt()
                frames_l += dec.STREAM_BLOCK * len(dec.stream_block_seconds)
                want.append(json.dumps(cli.segment_doc(dec, start, end)))
            else:
                dec.decode_raw(speech)
                raw_docs.append(cli.segment_doc(dec, start, end))
    if live != want:
        raise AssertionError(f"cli live {live} != the decoder's {want}")
    if cuda and live_l != dict.fromkeys(KERNELS, frames_l):
        raise AssertionError(f"cli live launches {live_l} != frames "
                             f"stepped {frames_l}")
    res = dict(single=dict(seconds=single_secs, launches=single_l,
                           hyp=json.loads(single[0])["t"]),
               live=dict(seconds=live_secs, launches=live_l,
                         segments=len(segs),
                         hyps=[json.loads(x)["t"] for x in live],
                         decode_raw_equal_hyps=sum(
                             json.loads(x)["t"] == d["t"]
                             for x, d in zip(live, raw_docs))),
               decoder_build_s=build_s, equal=True)
    log("phase 10(a) cli: " + json.dumps(res))
    return res, dec


def cli_1k7(work, device, log=print, hmm=None, dic=None, lmfile=None,
            n_align=20):
    """Phase 10(a'): at the 1.7k width (`hmm` with `dic` and `lmfile`,
    default bench-1.7k): `align` of `n_align` dictionary words with
    -phone_align and -state_align yes over a seeded 6 s WAV, its JSON
    equal to the alignment of a `Decoder` (`add_align_text`, `decode_raw`)
    of the same PCM; `live` over phase 10(a)'s seeded bursts, and
    `compat.AudioFile` over the same file giving the same hypotheses."""
    import io
    from pocketsphinx_tpu_torch import Decoder, cli, compat
    from pocketsphinx_tpu_torch.testing import synth

    dic = dic or os.path.join(BENCH, "bench-1.7k.dic")
    lmfile = lmfile or os.path.join(BENCH, "bench-1.7k.lm.bin")
    words = synth.grammar_words(dic)
    rng = np.random.default_rng(320)
    text = [words[i] for i in rng.choice(len(words), n_align, replace=False)]
    pcm = synth.make_pcm(321, 6.0)
    wav = _write_wav(os.path.join(work, "cli_align.wav"), pcm)
    live_wav = _write_wav(os.path.join(work, "cli_live.wav"),
                          synth.bursts_pcm(LIVE_SEED, LIVE_SECONDS))
    got, align_secs, _ = run_cli(["-hmm", hmm, "-dict", dic, "-phone_align",
                                  "yes", "-state_align", "yes", "align", wav,
                                  *text], device)
    dec = Decoder(hmm=hmm, dict=dic, device=device)
    dec.add_align_text(" ".join(text))
    dec.decode_raw(pcm)
    out = io.StringIO()
    cli.output_align(dec, True, True, stream=out)
    if got != out.getvalue().splitlines():
        raise AssertionError("cli align differs from Decoder.get_alignment")
    w, p, s = dec.get_alignment()
    live, live_secs, _ = run_cli(["-hmm", hmm, "-dict", dic, "-lm", lmfile,
                                  "live", live_wav], device)
    af = [ps.hypothesis() for ps in compat.AudioFile(
        live_wav, hmm=hmm, dict=dic, lm=lmfile, device=device)]
    hyps = [json.loads(x)["t"] for x in live]
    if af != hyps:
        raise AssertionError(f"AudioFile {af} != cli live {hyps}")
    res = dict(align=dict(seconds=align_secs, words=len(w), phones=len(p),
                          states=len(s), equal=True),
               live=dict(seconds=live_secs, hyps=hyps), audiofile_equal=True)
    log("phase 10(a') cli at 1.7k: " + json.dumps(res))
    return res


def _flat_search(hmm, dic, lmfile, device):
    """The `Decoder` with PS_NGRAM_IMPL=flat over a model directory, and
    its flat search."""
    from pocketsphinx_tpu_torch import Decoder
    with _env("PS_NGRAM_IMPL", "flat"):
        dec = Decoder(hmm=hmm, dict=dic, lm=lmfile, device=device)
    return dec, dec._searches["_default"]


def _flat_equal(a, b, what):
    """Two flat decodes' (records, (hyp, segs)) equal."""
    (ra, (ha, sa)), (rb, (hb, sb)) = a, b
    names = "escore estf eprw eascr eh1 eh2 ectx".split()
    for n, x, y in zip(names, ra, rb):
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: records differ: {n}")
    if (ha, seg_key(sa)) != (hb, seg_key(sb)):
        raise AssertionError(f"{what}: {ha!r} != {hb!r}")


def _host(x):
    """An array on the host (a tensor's copy)."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def flat_1k7(work, device, log=print, hmm=None, dic=None, lmfile=None):
    """Phase 10(b): the flat search at the 1.7k width through the `Decoder`
    with PS_NGRAM_IMPL=flat: one B=8 batch of seeded 2-5 s utterances
    through `decode_batch` on `device`, ms per frame and peak memory; its
    three shortest rows' 7 record arrays, hypotheses and segments equal to
    a B=3 batch of the same search on the CPU from the same costs; one
    `decode_raw` with the best-path pass; how many hypotheses the fused search gives
    equal on the same costs (counted, not required: the two differ in mpx
    semantics)."""
    from pocketsphinx_tpu_torch import Decoder
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores
    from pocketsphinx_tpu_torch.testing import synth

    dic = dic or os.path.join(BENCH, "bench-1.7k.dic")
    lmfile = lmfile or os.path.join(BENCH, "bench-1.7k.lm.bin")
    t0 = time.perf_counter()
    dec, flat = _flat_search(hmm, dic, lmfile, device)
    flat._tables()
    build_s = time.perf_counter() - t0
    batch, held = 8, 3
    pcm, ns = pcm_batch(list(range(330, 330 + batch)),
                        list(np.linspace(2.0, 5.0, batch)))
    feats, nf = features(en_us_frontend(), pcm, ns, device)
    nf = _host(nf)
    costs = senone_scores(dec.am.scoring_tensors(dec.device), feats,
                          time_chunk=16)
    T = costs.shape[1]
    _reset_peak(device)
    t0 = _sync(device)
    out = flat.decode_batch(None, nf, costs=costs)
    secs = _sync(device) - t0
    peak = _peak(device)
    recs = list(flat.batch_records)
    res = dict(W=flat.W, P=flat.P, batch=batch, frames=int(T),
               build_s=build_s, seconds=secs, ms_per_frame=secs / T * 1e3,
               peak_mem_bytes=peak, lm_order_used=flat.lm_order_used,
               hyps=[h for h, _ in out][:4])
    cpu = flat.to("cpu")
    t0 = time.perf_counter()
    out_c = cpu.decode_batch(None, nf[:held], costs=costs[
        :held, :int(nf[:held].max())].cpu())
    res["cpu_s"] = time.perf_counter() - t0
    for b, n in enumerate(nf[:held]):
        _flat_equal((tuple(r[:n] for r in recs[b]), out[b]),
                    (tuple(r[:n] for r in cpu.batch_records[b]), out_c[b]),
                    f"flat row {b} {device} vs cpu")
    res["cpu_equal_rows"] = held
    h = dec.decode_raw(synth.make_pcm(340, 3.0))
    lat = dec.get_lattice()
    if not (h and h.hypstr and lat and 0.0 < h.prob <= 1.0):
        raise AssertionError(f"flat decode_raw: {h}")
    res["decode_raw"] = dict(hyp=h.hypstr, prob=h.prob, nodes=lat.n_nodes,
                             links=lat.n_links)
    fused = Decoder(hmm=hmm, dict=dic, lm=lmfile, device=device)
    fo = fused._searches["_default"].decode_batch(None, nf, costs=costs)
    res["fused_equal_hyps"] = sum(a[0] == b[0] for a, b in zip(out, fo))
    log("phase 10(b) flat at 1.7k: " + json.dumps(res, default=float))
    return res


def flat_20k(dec, device, log=print):
    """Phase 10(c): the flat search at the 20k width on `dec`'s model,
    dictionary and LM (phase 10(a)'s decoder): one 2 s utterance at B=1
    (`decode`), its records, hypothesis and segments equal to its own row
    of a B=2 `decode_batch` with a 1.2 s partner; ms per frame and peak
    memory of each."""
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores
    from pocketsphinx_tpu_torch.search.ngram_flat import NgramFlatDecoder

    c = dec.config
    t0 = time.perf_counter()
    flat = NgramFlatDecoder(dec.am, dec.d2p, dec._searches["_default"].lm,
                            silprob=c["silprob"], fillprob=c["fillprob"],
                            pip=c["pip"], nwpen=c["nwpen"], device=device)
    flat._tables()
    build_s = _sync(device) - t0
    pcm, ns = pcm_batch([350, 351], [2.0, 1.2])
    feats, nf = features(en_us_frontend(), pcm, ns, device)
    nf = _host(nf)
    costs = senone_scores(dec.am.scoring_tensors(dec.device), feats,
                          time_chunk=16)
    T = int(nf[0])
    _reset_peak(device)
    t0 = _sync(device)
    one = flat.decode(None, costs=costs[0, :T])
    t1 = _sync(device)
    peak1 = _peak(device)
    rec1 = flat.records
    _reset_peak(device)
    t2 = _sync(device)
    two = flat.decode_batch(None, nf, costs=costs)
    t3 = _sync(device)
    _flat_equal((rec1, one), (tuple(r[:T] for r in flat.batch_records[0]),
                              two[0]), "flat 20k B=1 vs its B=2 row")
    res = dict(W=flat.W, P=flat.P, n_slot=flat.n_slot, build_s=build_s,
               lm_order_used=flat.lm_order_used, frames=T,
               b1_ms_per_frame=(t1 - t0) / T * 1e3, b1_peak_mem_bytes=peak1,
               b2_frames=int(costs.shape[1]),
               b2_ms_per_frame=(t3 - t2) / costs.shape[1] * 1e3,
               b2_peak_mem_bytes=_peak(device), hyp=one[0], equal=True)
    log("phase 10(c) flat at 20k: " + json.dumps(res, default=float))
    return res


def topk_exact(dec, device, log=print):
    """Top-K exactness on phase 5's decoder `dec`: phase 5's first two
    utterances decoded at its K and unpruned (a copy with topk = W): the
    hypotheses, segments and exit records (all but the guard count), held
    equal only where the K run's guard count is 0; both runs' ms per frame
    and the unpruned run's peak memory.  If the unpruned scan does not fit
    on the card, says so and returns the K runs' guard counts alone."""
    import copy
    import torch
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores

    fe = en_us_frontend()
    costs = []
    for i in range(2):                  # as `main_path` makes them
        pcm, ns = pcm_batch([1 + i], [2.0 + 1.5 * i])
        feats, nf = features(fe, pcm, ns, device)
        costs.append(senone_scores(dec.am.scoring_tensors(dec.device),
                                   feats[:, :int(nf[0])])[0])

    def run(d, c):
        _reset_peak(device)
        t0 = _sync(device)
        hyp, segs = d.decode(None, costs=c)
        secs = _sync(device) - t0
        return (hyp, seg_key(segs), d.raw_records, d.guard_violations,
                secs / c.shape[0] * 1e3, _peak(device))

    pruned = [run(dec, c) for c in costs]
    res = dict(K=dec.K, W=dec.W, utts=[])
    try:
        t0 = time.perf_counter()
        full = copy.copy(dec)
        full.topk = dec.W
        full.host_tables = full._host_tables()
        full.tables = full.device_tables(full.host_tables, dec.device)
        res["build_s"] = time.perf_counter() - t0
        unpruned = [run(full, c) for c in costs]
    except torch.cuda.OutOfMemoryError as e:
        full = unpruned = None
        torch.cuda.empty_cache()
        res.update(unpruned="does not fit", error=str(e)[:400],
                   guard=[p[3] for p in pruned])
        log("top-K exactness: " + json.dumps(res, default=float))
        return res
    names = "escore etf etgt ecx entry eprw erw1 erw2 m".split()
    for c, a, b in zip(costs, pruned, unpruned):
        (h, s, r, v, ms, _), (hf, sf, rf, vf, msf, peak) = a, b
        same_recs = all(np.array_equal(a, b)
                        for a, b in zip(r[:len(names)], rf[:len(names)]))
        u = dict(frames=int(c.shape[0]), guard=v, hyp_equal=h == hf,
                 segs_equal=s == sf, records_equal=same_recs, ms_per_frame=ms,
                 unpruned_ms_per_frame=msf, unpruned_peak_mem_bytes=peak,
                 unpruned_guard=vf)
        if v == 0 and not (u["hyp_equal"] and u["segs_equal"] and same_recs):
            raise AssertionError(f"K={dec.K} with guard 0 differs from the "
                                 f"unpruned search: {u}")
        res["utts"].append(u)
    del full
    log("top-K exactness: " + json.dumps(res, default=float))
    return res


# ---------------------------------------------------------------------------
# phase 11: tensor parallelism over the mesh's "model" axis
# ---------------------------------------------------------------------------

def _parts(n_utts, lens, batch, dp):
    """`decode_corpus`'s rows: for each batch of `batch` utterances in
    length order, the utterance indices of each of the `dp` data rows."""
    order = sorted(range(n_utts), key=lambda i: lens[i])
    return [[rows.tolist() for rows in np.array_split(
        np.array(order[i0:i0 + batch]), dp) if len(rows)]
            for i0 in range(0, n_utts, batch)]


def block_times(sp, costs, reps=10):
    """Device ms of one frame's word-transition block on `sp`, a decoder
    split over a "model" group, as its scan runs it: `_transitions` on
    the decoder's `_SplitBuffers` at the batch size of `costs`.  Returns
    (each part's block into its static outputs, on the stream it runs
    on: its card's own, or the lead's; the whole split block, on the
    lead's stream, which waits for every part: the blocks, the exits'
    copies to the parts on other cards, their outputs' copies back and
    the 7 joins into [B, E]; those copies and joins alone, issued as
    `_transitions` issues them).  CUDA events on each stream; the
    frame's exits come from a short scan of `costs` (`frame_exits`)."""
    import torch
    from pocketsphinx_tpu_torch.ops.transitions import transitions
    args = frame_exits(sp, costs)[0]
    layout, wpen = args[1], args[7]
    exits = tuple(x.to(sp.device) for x in args[2:7])
    buf = sp._split_buffers(exits[0].shape[0])
    lead = torch.cuda.current_stream(sp.device)
    away = [p for p in buf.parts if p.stream is not None]

    def ms(stream, fn):
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            fn()
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
            for _ in range(reps):
                fn()
            ev[1].record(stream)
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) / reps

    def copies():
        for p in away:
            p.stream.wait_stream(lead)
            with torch.cuda.stream(p.stream):
                for b, x in zip(p.exits, exits):
                    b.copy_(x)
                for b, o in zip(p.lead_outs, p.outs):
                    b.copy_(o)
            lead.wait_stream(p.stream)
        for i, out in enumerate(buf.joined):
            torch.cat([p.lead_outs[i] for p in buf.parts], 1, out=out)

    for p in away:
        for b, x in zip(p.exits, exits):
            b.copy_(x)
    torch.cuda.synchronize(sp.device)
    block_ms = [
        ms(lead if p.stream is None else p.stream,
           lambda p=p: transitions(p.tables, layout, *(p.exits or exits),
                                   wpen, out=p.outs))
        for p in buf.parts]
    split_ms = ms(lead, lambda: sp._transitions(*exits, wpen))
    return block_ms, split_ms, ms(lead, copies)


def tensor_parallel(dec, fe, mesh, pcms, ref, ref_guard, log=print, batch=8,
                    what="", check_graph=False):
    """Phase 11: `decode_corpus` of `pcms` through `dec` on `mesh` (a
    "model" axis), once, each replica's scan through its CUDA graph (one
    graph over its group's cards).  The fan and the chain launch once
    per frame stepped, on the leads, the word-transition kernel once per
    frame and part.  The split costs of each data row's batch are held
    to the unsplit ones (largest difference printed; within the scoring
    tolerance); where they are equal the (hyp, segments) must equal
    `ref` (the unsplit run's) and the guard count `ref_guard`, else each
    row's result must equal the unsplit search's on the split costs.  The
    first row's minimal records through the graph equal its eager step's
    and the unsplit scan's on the same costs, every record; with
    `check_graph`, `graph_vs_eager` holds that row's scan, carries and
    `decode_batch` results too, minimal and full.  Returns audio-s/s,
    scan ms per frame, peak memory per card, the bytes of the split
    replica's graph buffers and the block's device times (`block_times`)."""
    import torch
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline

    cuda = mesh.devices[0, 0].type == "cuda"
    cards = sorted({d.index for d in mesh.devices.reshape(-1)}) if cuda \
        else []
    t0 = time.perf_counter()
    pipe = BatchDecodePipeline(dec, fe, mesh=mesh)
    res = dict(mesh=[[str(d) for d in row] for row in mesh.devices],
               shard_build_s=time.perf_counter() - t0)
    lens = [len(p) for p in pcms]
    parts = _parts(len(pcms), lens, batch, mesh.shape["data"])
    ch = dec.CHUNK
    frames = sum(-(-fe.n_frames(max(lens[i] for i in rows)) // ch) * ch
                 for b in parts for rows in b)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    # what the peak starts from: the decoders alive on each card, and of
    # that the unsplit decoder's graph buffers
    res.update(live_bytes={c: torch.cuda.memory_allocated(c) for c in cards},
               graph_bytes=graph_bytes(dec))
    reset_counts()
    st = {}
    t0 = time.perf_counter()
    out = _results(pipe.decode_corpus(pcms, batch_size=batch, timings=st))
    for c in cards:
        torch.cuda.synchronize(c)
    dt = time.perf_counter() - t0
    res["launches"] = counts()
    # the block runs once per frame on each part of a data row's group
    want = dict(fan=frames, chain=frames,
                transitions=frames * mesh.shape["model"])
    if cuda and res["launches"] != want:
        raise AssertionError(f"phase 11{what}: launches {res['launches']} "
                             f"!= {want} (frames stepped {frames})")
    # scan seconds are summed over the data rows, which run at once
    res.update(audio_s_per_s=sum(lens) / fe.samprate / dt, seconds=dt,
               scan_ms_per_frame=st["scan"] / frames * 1e3,
               frames=frames, guard_violations=pipe.guard_violations,
               peak_mem_bytes={c: torch.cuda.max_memory_allocated(c)
                               for c in cards}, stages=st)
    # the costs, and the split search against the unsplit one
    err, want = 0.0, [None] * len(pcms)
    for b in parts:
        for rows, rep in zip(b, pipe.replicas):
            feats, nf = _row_feats(fe, pcms, rows, rep.device)
            costs = senone_scores(rep.scoring(), feats, time_chunk=16)
            whole = senone_scores(dec.am.scoring_tensors(rep.device), feats,
                                  time_chunk=16)
            e = float((costs - whole).abs().max())
            if e:
                torch.testing.assert_close(costs, whole, atol=2e-2,
                                           rtol=1e-5)
            err = max(err, e)
            got = dec.decode_batch(None, nf, False, costs.to(dec.device))
            for k, i in enumerate(rows):
                want[i] = _results([got[k]])[0]
            if res.get("min_records_equal") is None:
                valid = (torch.arange(costs.shape[1], device=rep.device)
                         [None, :] < torch.as_tensor(nf, device=rep.device)
                         [:, None])
                a = rep.scan(costs, valid, minimal=True)
                e = rep.scan(costs, valid, minimal=True, graph=False)
                r = dec.scan(costs.to(dec.device), valid.to(dec.device),
                             minimal=True)
                for n, x, y, z in zip("kv ki etf etgt rank m nviol".split(),
                                      a, e, r):
                    if not torch.equal(x, y):
                        raise AssertionError(f"phase 11{what}: minimal "
                                             f"record {n}: graph != eager")
                    if not torch.equal(x.to(dec.device), z):
                        raise AssertionError(f"phase 11{what}: minimal "
                                             f"record {n} differs")
                res["min_records_equal"] = True
                del a, e, r
                if check_graph:
                    res["graph_check"] = graph_vs_eager(
                        rep, costs, nf, f"phase 11{what}", log)
                if cuda:
                    res["graph_bytes_split"] = graph_bytes(rep)
                    (res["block_ms"], res["split_block_ms"],
                     res["copy_ms"]) = block_times(rep, costs)
    res["cost_max_abs_diff"] = err
    if err == 0.0 and (out != ref or res["guard_violations"] != ref_guard):
        raise AssertionError(f"phase 11{what}: split decode_corpus differs "
                             f"from the unsplit one on equal costs")
    if out != want:
        raise AssertionError(f"phase 11{what}: split decode_corpus differs "
                             f"from the unsplit search on the split costs")
    res["hyps"] = [h for h, _ in out][:4]
    log(f"phase 11{what}: " + json.dumps(res, default=float))
    return res


def graph_bytes(dec):
    """Bytes of the buffers `dec` keeps for its scan's CUDA graphs: the
    static inputs and carry, each graph's records and a split decoder's
    block buffers on every card (not the free blocks of their private
    pool)."""
    cache = dec.__dict__.get("_graphs")
    if not cache:
        return 0
    io = cache["inputs"]
    ts = [io.costs, io.valid, io.t_base]
    ts += [x for _, x in dec._carry_fields(io.carry)]
    for run in cache["runs"].values():
        ts += list(run.recs or ())
    split = cache.get("split")
    if split is not None:
        ts += list(split.joined)
        for p in split.parts:
            ts += [x for xs in (p.outs, p.exits, p.lead_outs)
                   for x in xs or ()]
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in ts}.values())


def tp_20k(dec, fe, log=print, batch=8, profile=False):
    """Phase 11(a): phase 5's 20k decoder (LM mode B) split in two parts
    on one card (`Mesh([["cuda:0", "cuda:0"]])`), one B=`batch` batch of
    phase 5's utterances through `decode_corpus`, held to the unsplit
    run (`tensor_parallel`, with `graph_vs_eager` on the split replica);
    with its scan ms per frame and peak memory beside the unsplit run's.
    With `profile`, `split_scan_modes` of the two parts beside the
    unsplit decoder."""
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
    from pocketsphinx_tpu_torch.parallel.batch import Mesh
    from pocketsphinx_tpu_torch.testing import synth
    pcms = [synth.make_pcm(10 + i, s) for i, s in
            enumerate(np.linspace(2.0, 5.0, batch))]
    dev = str(dec.device)
    st = {}
    _reset_peak(dev)
    pipe = BatchDecodePipeline(dec, fe, mesh=make_mesh(1, device=dec.device))
    t0 = _sync(dev)
    ref = _results(pipe.decode_corpus(pcms, batch_size=batch, timings=st))
    dt = _sync(dev) - t0
    frames = -(-fe.n_frames(max(len(p) for p in pcms)) // dec.CHUNK) \
        * dec.CHUNK
    unsplit = dict(scan_ms_per_frame=st["scan"] / frames * 1e3, seconds=dt,
                   peak_mem_bytes=_peak(dev))
    res = tensor_parallel(dec, fe, Mesh([[dev, dev]]), pcms, ref,
                          pipe.guard_violations, log=log, batch=batch,
                          what="(a) 20k mode B, one card", check_graph=True)
    res["unsplit"] = unsplit
    if profile:
        res["scan_modes"] = split_scan_modes(dec, [dev, dev], fe, log)
    log(f"phase 11(a): scan {res['scan_ms_per_frame']:.3f} ms per B={batch} "
        f"frame split in two on one card, {unsplit['scan_ms_per_frame']:.3f} "
        f"unsplit; peak "
        f"{max(res['peak_mem_bytes'].values(), default=0) / 2**30:.2f} GiB "
        f"({(unsplit['peak_mem_bytes'] or 0) / 2**30:.2f} unsplit); costs "
        f"differ by at most {res['cost_max_abs_diff']}")
    return res


def tp_cards(work, log=print, batch=8, profile=False):
    """`--tp`: phase 11(b)-(d) alone.  Builds phase 9's task, decodes its
    utterances once unsplit on one card through `decode_corpus` (the
    reference), then runs `tp_126k` with `split_scan_modes` of each
    group."""
    from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, make_mesh
    t0 = time.perf_counter()
    dec, res = reference_decoder(work, "cuda")
    fe = en_us_frontend()
    pcms = reference_utterances(batch)
    lens = [len(p) for p in pcms]
    frames = sum(-(-fe.n_frames(max(lens[i] for i in rows)) // dec.CHUNK)
                 * dec.CHUNK for b in _parts(len(pcms), lens, batch, 1)
                 for rows in b)
    pipe = BatchDecodePipeline(dec, fe, mesh=make_mesh(1, device=dec.device))
    st = {}
    first = _results(pipe.decode_corpus(pcms, batch_size=batch, timings=st))
    held = dict(decoder=dec, pcms=pcms, first=first,
                guard=pipe.guard_violations,
                scan_ms_per_frame=st["scan"] / frames * 1e3)
    log(f"--tp: 126k task built and decoded unsplit in "
        f"{time.perf_counter() - t0:.1f} s ({json.dumps(res)}), scan "
        f"{held['scan_ms_per_frame']:.3f} ms per frame")
    return tp_126k(held, fe, log=log, batch=batch, profile=profile,
                   modes=True)


def tp_126k(held, fe, log=print, batch=8, profile=False, modes=False):
    """Phase 11(b)-(d) on phase 9's 126k decoder (LM mode C) and its
    utterances, each once, held to phase 9(b)'s first run
    (`tensor_parallel`): (b) two parts on one card; (c) with two or more
    cards, `make_mesh(1, 2)` over cards 0 and 1; (d) with four,
    `make_mesh(2, 2)` with `batch` utterances per data row.  (c) and (d)
    say so when they are skipped.  With `profile`, `profile_scan` of (c)'s
    split decoder and of the unsplit one (each card's busy share); with
    `modes`, `split_scan_modes` of (b)'s and (c)'s groups beside the
    unsplit decoder."""
    import torch
    from pocketsphinx_tpu_torch.parallel import make_mesh
    from pocketsphinx_tpu_torch.parallel.batch import Mesh
    dec, pcms = held["decoder"], held["pcms"]
    ref, guard = held["first"], held["guard"]
    res = {}
    dev = str(dec.device)
    res["b"] = tensor_parallel(dec, fe, Mesh([[dev, dev]]), pcms, ref, guard,
                               log=log, batch=batch,
                               what="(b) 126k mode C, one card")
    if modes:
        res["b"]["scan_modes"] = split_scan_modes(dec, [dev, dev], fe, log)
    n = torch.cuda.device_count()
    for key, nd, nm in (("c", 1, 2), ("d", 2, 2)):
        if n < nd * nm:
            res[key] = f"skipped: {n} card(s), needs {nd * nm}"
            log(f"phase 11({key}) {res[key]}")
            continue
        # `batch` rows per data row: phase 9(b)'s batches, so its shapes
        res[key] = tensor_parallel(dec, fe, make_mesh(nd, nm), pcms, ref,
                                   guard, log=log, batch=batch * nd,
                                   what=f"({key}) 126k mode C, "
                                        f"make_mesh({nd}, {nm})")
        if profile and key == "c":
            res["c"]["profile"] = profile_scan(
                dec.shard(make_mesh(1, 2).devices[0]), fe, log, batch=batch)
            res["c"]["profile_tp1"] = profile_scan(dec, fe, log, batch=batch)
        if modes and key == "c":
            res["c"]["scan_modes"] = split_scan_modes(
                dec, list(make_mesh(1, 2).devices[0]), fe, log)
    for key in ("b", "c", "d"):
        r = res[key]
        if isinstance(r, dict):
            gib, live = ({c: round(m / 2**30, 3) for c, m in r[k].items()}
                         for k in ("peak_mem_bytes", "live_bytes"))
            log(f"phase 11({key}): {r['audio_s_per_s']:.2f} audio-s/s, scan "
                f"{r['scan_ms_per_frame']:.3f} ms per frame (tp=1: "
                f"{held['scan_ms_per_frame']:.3f}), peak per card {gib} "
                f"GiB (live before the run {live} GiB, of which the unsplit "
                f"decoder's graph buffers "
                f"{r['graph_bytes'] / 2**30:.3f} GiB), block ms per part "
                f"{r.get('block_ms')}, split block ms per frame "
                f"{r.get('split_block_ms')} (copies and joins "
                f"{r.get('copy_ms')})")
    return res


def _row_feats(fe, pcms, rows, device):
    """The features [B, T, F, L] and frame counts of utterances `rows`,
    padded as `decode_corpus` pads one data row's batch."""
    pcm = np.zeros((len(rows), max(len(pcms[i]) for i in rows)), np.float32)
    for k, i in enumerate(rows):
        pcm[k, :len(pcms[i])] = pcms[i]
    ns = np.array([len(pcms[i]) for i in rows], np.int32)
    return features(fe, pcm, ns, device)


# ---------------------------------------------------------------------------
# phases (need CUDA)
# ---------------------------------------------------------------------------

def profile_scan(dec, fe, log, frames=64, batch=8):
    """torch.profiler over `frames` scan steps of a B=`batch` minimal-
    record decode: device time by kernel, each device's busy share of
    the wall time (the profiler's own overhead lowers that share), the
    device launches per frame (kernels, copies and fills: the count of
    every device row) and the fan's and the word-transition kernel's
    shares of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores

    pcm, ns = pcm_batch(list(range(10, 10 + batch)),
                        list(np.linspace(2.0, 5.0, batch)))
    feats, _ = features(fe, pcm, ns, "cuda")
    costs = senone_scores(dec.scoring(), feats[:, :frames], time_chunk=16)
    valid = torch.ones(costs.shape[:2], dtype=torch.bool, device=dec.device)
    dec.scan(costs, valid, minimal=True)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.scan(costs, valid, minimal=True)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.scan(costs, valid, minimal=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    # kernels only: the aten ops' own rows repeat their kernels' time
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    dev_us = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows) / frames
    fan_us = sum(r[2] for r in rows if "fan_kernel" in r[0])
    tr_us = sum(r[2] for r in rows if "transitions_kernel" in r[0])
    busy = {}                          # device time by card (a model group)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) \
                + e.device_time_total
    log(f"profile: {frames} frames at B={batch}: wall {plain_wall * 1e3:.1f} "
        f"ms unprofiled ({plain_wall / frames * 1e3:.3f} ms/frame), "
        f"{wall * 1e3:.1f} ms profiled; device busy {dev_us / 1e3:.1f} ms "
        f"= {dev_us / 1e6 / wall:.3f} of the profiled wall, "
        f"{dev_us / 1e6 / plain_wall:.3f} of the unprofiled one; by card "
        f"{ {c: round(us / 1e6 / wall, 3) for c, us in sorted(busy.items())} }"
        f" of the profiled wall; {dev_us / frames / 1e3:.3f} ms of device "
        f"time and {launches:.1f} device launches per frame, the fan "
        f"{fan_us / dev_us:.3f} and the word-transition kernel "
        f"{tr_us / dev_us:.3f} of the device time")
    for key, count, us in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {us / dev_us:6.3f}  {key[:90]}")
    return dict(frames=frames, batch=batch, wall_s=plain_wall,
                device_s=dev_us / 1e6, top=rows[:15], profiled_wall_s=wall,
                launches_per_frame=launches, fan_share=fan_us / dev_us,
                transitions_share=tr_us / dev_us,
                device_s_by_card={c: us / 1e6 for c, us in busy.items()})


def fan_bytes(B, NRC, W, LP):
    """Bytes a fan step over W words must move, counted without the
    carry's pads: the S/TF/CX planes read and written, the exit plane,
    pred/ptf/pcx, the exits, pre, lp, tp and the [B] maximum."""
    return 4 * (18 * B * NRC * W + B * NRC * W + 6 * B * W
                + 3 * B * NRC * LP + 13 * W + B)


def check_fan(B, NRC, W, LP, log):
    """The fan kernel against its plain version on `fan_inputs`, ties off
    and on: every output bit-equal, the exit plane written into columns
    [0, W) of a [B, NRC, W + 13] buffer (the 20k scan's exit planes have
    13 more columns) whose other columns keep their values, and the max
    of the kernel's partial maxima equal to the plain version's; then
    both timed, and the kernel's device time at each choice of its plane
    groups (`fan.GROUPS`; the wrapper's choice is `groups`)."""
    import torch
    from pocketsphinx_tpu_torch.ops import fan
    rng = np.random.default_rng(0)
    err = 0.0
    for ties in (False, True):
        dev = to_device(fan_inputs(rng, B, NRC, W, LP, ties), "cuda")
        bufs = [torch.full((B, NRC, W + 13), 7.0, device="cuda")
                for _ in range(2)]
        outs = fan.fan_step(**dev, out_f=bufs[0][:, :, :W])
        torch.cuda.synchronize()
        refs = fan.fan_step_ref(**dev, out_f=bufs[1][:, :, :W])
        err = max(err, compare(outs[:7] + (outs[7].amax(1), bufs[0]),
                               refs[:7] + (refs[7].amax(1), bufs[1]),
                               f"fan ties={ties}"))
    view = bufs[0][:, :, :W]
    ms, plain, wms, wplain = timings(
        lambda: fan.fan_step(**dev, out_f=view),
        lambda: fan.fan_step_ref(**dev, out_f=view))
    by_groups = {g: time_ms(lambda: fan.fan_step(**dev, out_f=view,
                                                 groups=g), graph=True)
                 for g in fan.GROUPS}
    groups = fan._groups(B, dev["S"].shape[-1], LP, torch.cuda.
                         get_device_properties(0).multi_processor_count)
    bms, by = bound_ms(fan_bytes(B, NRC, W, LP), 18 * B * NRC * W)
    log(f"fan B={B} NRC={NRC} W={W} LP={LP}: bit-equal (exit plane into a "
        f"strided view, partial maxima); device time: kernel {ms:.4f} ms "
        f"({groups} plane groups; by groups "
        f"{ {g: round(t, 4) for g, t in by_groups.items()} }), plain "
        f"{plain:.4f} ms; through Python: kernel {wms:.4f} ms, plain "
        f"{wplain:.4f} ms; bound {bms:.4f} ms ({by}), {bms / ms:.3f} of it")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, wrapper_ms=wms, plain_wrapper_ms=wplain,
                groups=groups, ms_by_groups=by_groups)


def check_chain(B, buckets, log):
    """The grouped chain step over one frame's buckets, (NST, D, W, RF,
    NFD, has_var) each in layout order: bit-equal to its plain version
    with ties off and on, then timed."""
    import torch
    from pocketsphinx_tpu_torch.ops import chain
    rng = np.random.default_rng(1)
    err = 0.0
    for ties in (False, True):
        per = [chain_inputs(rng, B, *bk, ties) for bk in buckets]
        grp, args = chain_group_args(per, "cuda")
        outs = chain.chain_group_step(grp, **args)
        torch.cuda.synchronize()
        refs = chain.chain_group_ref(grp, **args)
        err = max(err, compare(outs, refs, f"chain ties={ties}"))
    # bound as for one launch per bucket: each bucket's inputs read once,
    # its outputs (S/TF/CTX planes, VAR, 3 exit rows) written once
    tot_bytes = tot_ops = 0
    for (NST, D, W, *_), p in zip(buckets, per):
        tot_bytes += nbytes(p, []) + 4 * B * (3 * NST * D * W + NST * W
                                              + 3 * W)
        tot_ops += 12 * B * NST * D * W
    bms, by = bound_ms(tot_bytes, tot_ops)
    ms, plain, wms, wplain = timings(
        lambda: chain.chain_group_step(grp, **args),
        lambda: chain.chain_group_ref(grp, **args))
    log(f"chain B={B}, {len(buckets)} buckets {[b[1:3] for b in buckets]} "
        f"in one launch ({grp.n_blocks} blocks): bit-equal; device time: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms; through Python: kernel "
        f"{wms:.4f} ms, plain {wplain:.4f} ms; bound {bms:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, wrapper_ms=wms, plain_wrapper_ms=wplain)


def transitions_bytes(args, am):
    """Bytes the word-transition block must move for `frame_exits`
    arguments `args`, given its winners `am` [B, E]: the exits and their
    exit planes, the [E] column tables (the accept table as its packed
    bits), the LM data these exits' contexts select (each distinct dense
    row once; each distinct history's CSR entries and metadata row; each
    distinct trigram context's corrections), the winners' successor-
    context elements, and the seven [B, E] outputs, each once."""
    import torch
    tb, lm, kv, ki, ctx_k, fb_k, svk, wpen = args
    B, K = kv.shape
    nE = tb["isfill_E"].shape[0]
    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    n = sum(size(x) for x in (kv, ki, ctx_k, fb_k, svk))
    n += nE * (8 + 1 + 4 + 1 + 4 + 8)           # f0p fill pen real lmwid acc
    n += B * nE * (4 + 8 + 8 + 4 + 4 + 4 + 8)   # the outputs
    ctx = ctx_k.long()
    if lm.mode == "rows":
        rows = torch.unique(ctx)
        n += len(rows) * (nE + 2) * 4                 # rows, rows_h
        rw1 = tb["rows_h"][ctx, 0].long()
    else:
        is_tri = ctx > lm.V
        bidx = torch.clamp(ctx - 1 - lm.V, 0, max(lm.n_bg - 1, 0))
        meta = tb["bgmeta"][bidx]
        rw1 = torch.where(is_tri, meta[..., 0].long(),
                          torch.where(ctx > 0, ctx - 1, lm.V))
        h1 = torch.unique(torch.clamp(rw1, max=lm.V))
        tri = torch.unique(bidx[is_tri])
        n += len(torch.unique(bidx)) * 32             # bgmeta rows
        n += int(tb["bgmeta"][tri, 4].clamp(max=lm.s_tri).sum()) * 8
        if lm.mode == "sparse":
            n += len(h1) * nE * 4                     # bg rows
        else:
            um = tb["umeta"][h1]
            fat = um[:, 3] >= 0                       # -1 unless fat
            n += len(h1) * 16 + nE * 8                # umeta, uni, ctx_base
            n += int(um[~fat, 1].clamp(max=lm.sb).sum()) * 16
            n += int(fat.sum()) * nE * 8              # fat rows and contexts
    if lm.mode != "csr":
        win = torch.gather(rw1, 1, am).clamp(min=0)   # [B, E] ctx_next rows
        col = torch.arange(nE, device=am.device)
        n += len(torch.unique(win * nE + col)) * 4
    return n


def transition_options():
    """The word-transition kernel's launch options, (columns per thread,
    splits of the exits), each held and timed by `check_transitions`."""
    from pocketsphinx_tpu_torch.ops import transitions as tr
    return [(c, k) for c in tr.COLS_PER_THREAD for k in tr.K_SPLITS]


def hold_transitions(cases, what):
    """Every case's (`frame_exits` arguments) kernel outputs at the
    default launch shape and at every launch option equal its plain
    version's, each launch counted; returns max |diff|."""
    from pocketsphinx_tpu_torch.ops import transitions as tr
    err = 0.0
    for name, args in cases.items():
        ref = tr.transitions_ref(*args)
        for c, k in [(None, None)] + transition_options():
            n = tr.launches
            outs = tr.transitions(*args, cols_per_thread=c, k_split=k)
            _sync(args[2].device)
            if tr.launches != n + 1:
                raise AssertionError("transitions did not count its launch")
            err = max(err, compare(outs, ref, f"transitions {what} {name} "
                                   f"cols={c} k_split={k}"))
    return err


def check_transitions(dec, fe, log, batch=8, seed=4):
    """The word-transition kernel against its plain version at `dec`'s
    shapes, on a real frame's exits (`frame_exits` of a short scan of
    phase 5's utterances), on the same exits with ties (`tie_exits`) and
    with one live exit (`solo_exits`), at the default launch shape and at
    every launch option (columns per thread x splits of the exits): all
    seven outputs bit-equal; then both timed on the real exits
    (CUDA-graph replay for device time, and through Python), the kernel
    at each launch option, with its bytes bound and each option's shared
    memory per block."""
    import torch
    from pocketsphinx_tpu_torch.models.acoustic import senone_scores
    from pocketsphinx_tpu_torch.ops import transitions as tr
    pcm, ns = pcm_batch(list(range(10, 10 + batch)),
                        list(np.linspace(2.0, 5.0, batch)))
    feats, _ = features(fe, pcm, ns, "cuda")
    costs = senone_scores(dec.scoring(), feats[:, :2 * dec.CHUNK],
                          time_chunk=16)
    real = frame_exits(dec, costs)[0]
    err = hold_transitions(dict(
        real=real, tied=tie_exits(real, np.random.default_rng(seed)),
        solo=solo_exits(real)), dec.lm_mode)
    ms, plain, wms, wplain = timings(lambda: tr.transitions(*real),
                                     lambda: tr.transitions_ref(*real))
    by_opt = {f"{c}x{k}": time_ms(lambda: tr.transitions(
        *real, cols_per_thread=c, k_split=k), graph=True)
        for c, k in transition_options()}
    tb, lm, kv = real[:3]
    B, K = kv.shape
    nE = tb["isfill_E"].shape[0]
    NRC = real[6].shape[1]
    nw = tb["accept_bits"].shape[0]
    cols, ks = tr.launch_shape(B, nE, K, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    kc = min(-(-K // 32) * 32, tr._KC)
    smem = {f"{c}x{k}": tr._smem_bytes(lm.mode, kc, NRC, c, k, nw)
            for c, k in transition_options()}
    bms, by = bound_ms(transitions_bytes(real, tr.transitions_ref(*real)[1]),
                       7 * B * K * nE)
    log(f"transitions mode {dec.lm_mode} B={B} K={K} E={nE} NRC={NRC} "
        f"NW={nw}: bit-equal, real, tied and one-live exits, every launch "
        f"option; device time: kernel {ms:.4f} ms (default {cols} columns "
        f"per thread x {ks} splits; by option (columns x splits) "
        f"{ {o: round(t, 4) for o, t in by_opt.items()} }), plain "
        f"{plain:.4f} ms; through Python: kernel {wms:.4f} ms, plain "
        f"{wplain:.4f} ms; bound {bms:.4f} ms ({by}), {bms / ms:.3f} of it; "
        f"shared memory per block by option {smem}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, wrapper_ms=wms, plain_wrapper_ms=wplain,
                cols_per_thread=cols, k_split=ks, ms_by_option=by_opt,
                smem_by_option=smem, mode=dec.lm_mode, B=B, K=K, E=nE)


def phones_decoder(work, device, mode, n_extra=28, n_words=300, topk=8):
    """A decoder of a synthetic model with 42 + `n_extra` CI phones
    (`synth.make_model(n_extra_phones=...)`, whose words end in phones
    past 64) over `n_words` bench-1.7k words rewritten with the extra
    phones and a seeded ARPA LM with up to 40 trigrams per context, in LM
    mode `mode` (mode C forced by a small table budget), on `device`."""
    from pocketsphinx_tpu_torch.testing import synth
    d = os.path.join(work, f"phones_{mode}")
    os.makedirs(d, exist_ok=True)
    dic = os.path.join(d, "small.dic")
    words = synth.small_dictionary(dic, n_words=n_words, n_single=3, seed=6,
                                   n_extra_phones=n_extra)
    lmf = synth.write_arpa(words, os.path.join(d, "small.arpa"), seed=8,
                           max_tri=40)
    spec = synth.make_model([dic], seed=9, n_sen=3 * (42 + n_extra) + 300,
                            n_density=8, n_extra_phones=n_extra)
    with _env("PS_LM_MODE", mode), _env("PS_LM_TABLE_BYTES", "1000"):
        dec = synth.build_decoder(spec, d, dic, lmf, topk=topk,
                                  device=device)
    if dec.lm_mode != mode:
        raise AssertionError(f"phones decoder LM mode {dec.lm_mode}")
    return dec


def check_phones(work, log, n_extra=28, frames=50, device="cuda"):
    """Phase 3(b): a model with 42 + `n_extra` CI phones (two accept words
    per column) at a small size on the card, in LM modes B and C: the
    word-transition kernel held bit-equal to its plain version at every
    launch option on a K = W frame's real, tied and one-live exits, and a
    `frames`-frame decode whose records, hypothesis and score equal the
    same decoder moved to the CPU, from one cost matrix."""
    import torch
    from pocketsphinx_tpu_torch.ops import transitions as tr
    res = dict(max_abs_err=0.0, launches=0)
    for mode in ("sparse", "csr"):
        dec = phones_decoder(work, device, mode, n_extra, topk=10 ** 6)
        c = np.random.default_rng(5).uniform(0, 400, (3, 24, dec.am.n_sen))
        c[:, -1] = 1e29
        real = frame_exits(dec, torch.as_tensor(c.astype(np.float32),
                                                device=device))[0]
        if not bool((real[5] >= 64).any()):
            raise AssertionError("no exit ends in a phone past 64")
        res["max_abs_err"] = max(res["max_abs_err"], hold_transitions(dict(
            real=real, tied=tie_exits(real, np.random.default_rng(2)),
            solo=solo_exits(real)), f"{mode} {42 + n_extra} phones"))
        dec = phones_decoder(work, device, mode, n_extra)
        costs = np.random.default_rng(6).uniform(
            0, 400, (frames, dec.am.n_sen)).astype(np.float32)
        n = tr.launches
        hyp, _ = dec.decode(None, costs=costs)
        res["launches"] += tr.launches - n
        if dec.device.type == "cuda" and tr.launches - n != \
                -(-frames // dec.CHUNK) * dec.CHUNK:
            raise AssertionError(f"transitions launched {tr.launches - n} "
                                 f"times for {frames} frames")
        cpu = dec.to("cpu")
        hyp_c, _ = cpu.decode(None, costs=costs)
        for i, (a, b) in enumerate(zip(dec.raw_records, cpu.raw_records)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{42 + n_extra} phones, mode {mode}: "
                                     f"record {i} differs from the CPU's")
        if (hyp, dec.hyp_score) != (hyp_c, cpu.hyp_score):
            raise AssertionError(f"{42 + n_extra} phones, mode {mode}: "
                                 f"hypothesis differs from the CPU's")
        res[mode] = dict(E=dec.nE, NW=int(dec.tables["accept_bits"].shape[0]),
                         hyp=hyp, score=dec.hyp_score)
    log(f"phase 3(b) {42 + n_extra} CI phones: kernel bit-equal at every "
        f"launch option (modes B and C, K = W), decode on the card equal "
        f"to the CPU: " + json.dumps(res, default=float))
    return res


def ptxas_summary(log_text, kernel="transitions_kernel"):
    """Registers, spill stores and loads of each instance of `kernel` in
    nvcc's `-Xptxas -v` output: {mangled name: (registers, spill store
    bytes, spill load bytes)}."""
    import re
    out, name, spill = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            t = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E", name)
            key = (f"mode{t.group(1)}_cols{t.group(2)}_"
                   f"{'nw1' if t.group(3) == '1' else 'nw_any'}" if t
                   else name)
            out[key] = (int(m.group(1)),) + spill
    return out


def exit_block_ms(arcs, rows_per_arc, log):
    """Device ms of the grammar search's [A, A] exit block (the gather of
    each arc's exit class, `+ M`, first max over the source axis) on
    random inputs, for each A in `arcs` (P = A * rows_per_arc HMM rows),
    timed as CUDA-graph replays, with its bytes bound: how the block
    scales with the grammar's size."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for A in arcs:
        P = int(A * rows_per_arc)
        x = torch.rand(P, device="cuda", generator=gen) * -500
        xn = torch.randint(0, P, (A, A), device="cuda", generator=gen)
        M = torch.rand((A, A), device="cuda", generator=gen) * -50
        ms = time_ms(lambda: torch.max(x[xn] + M, dim=0), reps=5,
                     trials=7, graph=True)
        # index, M and the exits read, the [A] max and argmax written
        bms, _ = bound_ms(12 * A * A + 4 * P + 12 * A, 2 * A * A)
        out[A] = dict(ms=ms, bound_ms=bms)
        del xn, M
        log(f"grammar exit block A={A} (P={P}): {ms:.4f} ms device, bound "
            f"{bms:.4f} ms")
    return out


def check_ties(log):
    """argmax / max(dim) give the first maximum and a stable descending
    sort keeps ties in index order, on CUDA, as on the CPU."""
    import torch
    rng = np.random.default_rng(2)
    x = rng.integers(0, 4, (64, 2000)).astype(np.float32)
    x[::7] = NEG_INF                                   # all-dead rows
    xc = torch.as_tensor(x, device="cuda")
    want_am = np.argmax(x, axis=1)
    for name, got in (("argmax", torch.argmax(xc, dim=1)),
                      ("max(dim)", torch.max(xc, dim=1).indices)):
        if not np.array_equal(got.cpu().numpy(), want_am):
            raise AssertionError(f"{name} is not first-max on CUDA")
    want_am0 = np.argmax(x, axis=0)
    for name, got in (("argmax(dim=0)", torch.argmax(xc, dim=0)),
                      ("max(dim=0)", torch.max(xc, dim=0).indices)):
        if not np.array_equal(got.cpu().numpy(), want_am0):
            raise AssertionError(f"{name} is not first-max on CUDA")
    order = torch.sort(xc, dim=1, descending=True, stable=True).indices
    if not np.array_equal(order.cpu().numpy(),
                          np.argsort(-x, axis=1, kind="stable")):
        raise AssertionError("stable descending sort tie order differs")
    log("ties: argmax, max(dim) first-max over dim 1 and 0; stable sort "
        "lower index first")


AB_RUN = r"""
import importlib.util, json, sys, tempfile, time
import torch
import chip_smoke
from pocketsphinx_tpu_torch.ops import _build
# the measurements of the chip_smoke.py that runs the comparison, on this
# tree's code
spec = importlib.util.spec_from_file_location("chip_smoke_ab", sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
quiet = lambda *a: None
_build.build(list(getattr(chip_smoke, "KERNELS", ("fan", "chain"))))
with tempfile.TemporaryDirectory() as w:
    t0 = time.perf_counter()
    dec, fe = chip_smoke.build_decoder("bench_data/bench-20k.dic",
                                       "bench_data/bench-20k.lm.bin", w,
                                       "cuda")
    out = {"build_s": time.perf_counter() - t0}
out["scan_20k"] = ab.scan_modes(dec, fe, quiet)
# B=1 with full records: the shape of `decode` and the stream
out["scan_20k_b1"] = ab.scan_modes(dec, fe, quiet, batch=1, minimal=False)
# the fan kernel at the 20k and 126k shapes (device ms, through Python)
for key, W in (("fan_20k", dec.n_multi), ("fan_126k", 125973)):
    r = chip_smoke.check_fan(8, dec.n_rcp, W, dec.senid_fin_d.shape[-1],
                             quiet)
    out[key] = [r["ms"], r["wrapper_ms"]]
# the word-transition kernel at the 20k, 1.7k and 126k shapes (device ms,
# through Python; by launch option where the tree has them)
def tr_times(key, d, f):
    r = chip_smoke.check_transitions(d, f, quiet)
    out[key] = [r["ms"], r["wrapper_ms"]]
    if "ms_by_option" in r:
        out[key + "_by_option"] = r["ms_by_option"]
tr_times("transitions_20k", dec, fe)
del dec
with tempfile.TemporaryDirectory() as w:
    d, f = chip_smoke.build_decoder("bench_data/bench-1.7k.dic",
                                    "bench_data/bench-1.7k.lm.bin", w,
                                    "cuda")
tr_times("transitions_1k7", d, f)
del d
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory() as w:
    d = chip_smoke.reference_decoder(w, "cuda")[0]
out["scan_126k"] = ab.scan_modes(d, chip_smoke.en_us_frontend(), quiet)
out["scan_126k_b1"] = ab.scan_modes(d, chip_smoke.en_us_frontend(), quiet,
                                    batch=1, minimal=False)
tr_times("transitions_126k", d, chip_smoke.en_us_frontend())
print(json.dumps(out))
"""


def ab(trees, log):
    """`--ab`: each checkout in turn (`AB_RUN` in the tree's directory,
    with its own code and `chip_smoke`): the 20k decoder's build seconds;
    `scan_modes` at 20k and at 126k (B=8 minimal records and B=1 full
    records: wall ms per frame, device ms per frame, busy share, device and host launches per frame, peak
    memory, through the graph and stepped eagerly, or the tree's one
    path); the fan kernel's device and through-Python ms at the 20k and
    126k shapes (its own `check_fan`) and the word-transition kernel's at
    the 20k, 1.7k and 126k shapes (`check_transitions`)."""
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", AB_RUN,
                            os.path.abspath(__file__)], cwd=tree,
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        log(json.dumps(dict(tree=tree, **res)))
        for width in ("20k", "20k_b1", "126k", "126k_b1"):
            for mode, m in res.get(f"scan_{width}", {}).items():
                log(f"{tree} {width} {mode}: wall "
                    f"{min(m['wall_ms_per_frame']):.3f}-"
                    f"{max(m['wall_ms_per_frame']):.3f} ms per frame, "
                    f"device {m['device_ms_per_frame']:.3f} ms, busy "
                    f"{m['busy']:.3f}, host launches "
                    f"{m['host_launches_per_frame']:.2f} per frame, peak "
                    f"{m['peak_alloc_bytes'] / 2**30:.2f} GiB")
    return 0


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import pocketsphinx_tpu_torch  # noqa: F401  (precision setup)
    from pocketsphinx_tpu_torch.ops import _build
    log = lambda *x: print(*x, flush=True)  # noqa: E731
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if argv[:1] == ["--ab"]:
        return ab(argv[1:], log)
    t0 = time.perf_counter()
    secs = _build.build(KERNELS, verbose=True)
    log(f"built kernels in {time.perf_counter() - t0:.1f} s: {secs}")
    ptx = ptxas_summary(_build.logs.get("transitions", ""))
    log("transitions kernel (registers, spill store bytes, spill load "
        "bytes) by (LM mode, columns per thread, accept words): "
        + json.dumps(ptx))
    if argv[:1] == ["--tp"]:
        with tempfile.TemporaryDirectory() as work:
            res = tp_cards(work, log=log, profile="--profile" in argv)
        print(json.dumps({"tp": res}, default=float), flush=True)
        print(smi, flush=True)
        return 0

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        dec, fe = build_decoder(os.path.join(BENCH, "bench-20k.dic"),
                                os.path.join(BENCH, "bench-20k.lm.bin"),
                                work, "cuda")
    log(f"20k decoder: W={dec.W} n_multi={dec.n_multi} E={dec.nE} "
        f"n_rc={dec.n_rcp} LM mode {dec.lm_mode}, chain buckets "
        f"{[(c.D, c.Wb, c.RF) for c in dec.chains]}, CI buckets "
        f"{[(c.D, c.Wb) for c in dec.ci_chains]}; host build "
        f"{time.perf_counter() - t0:.1f} s")
    if dec.lm_mode != "sparse":
        raise AssertionError(f"20k LM mode {dec.lm_mode} != sparse")
    B = 8
    fan_res = check_fan(B, dec.n_rcp, dec.n_multi,
                        dec.senid_fin_d.shape[-1], log)
    chain_res = check_chain(B, buckets_of(dec), log)
    tr_res = check_transitions(dec, fe, log, batch=B)
    with tempfile.TemporaryDirectory() as work:
        ph_res = check_phones(work, log)
    check_ties(log)
    t0 = time.perf_counter()
    res = main_path(dec, fe, "cuda", log=log)
    log(f"main path ({time.perf_counter() - t0:.1f} s): "
        + json.dumps(res, default=float))
    bt = res["batch"]
    log(f"B={bt['B']} batch: {bt['audio_s_per_s']:.2f} audio-s/s "
        f"(median of {len(bt['runs'])}: "
        f"{[round(r['audio_s_per_s'], 2) for r in bt['runs']]}), "
        f"peak memory {res['peak_mem_bytes'] / 2**30:.2f} GiB on {smi}")
    if "--profile" in argv:
        profile_scan(dec, fe, log)
        scan_modes(dec, fe, log)
    # phase 9(d) runs here, on phase 5's decoder, which is then freed
    t0 = time.perf_counter()
    top = guard_topm(dec, "cuda", log=log)
    top_s = time.perf_counter() - t0
    log(f"phase 9(d) ({top_s:.1f} s) on {smi}")
    # phase 10(d), top-K exactness, on the same decoder
    t0 = time.perf_counter()
    topk = topk_exact(dec, "cuda", log=log)
    t10 = time.perf_counter() - t0
    log(f"phase 10(d) ({t10:.1f} s) on {smi}")
    # phase 11(a), tensor parallelism at 20k, on the same decoder
    t0 = time.perf_counter()
    tp = {"a": tp_20k(dec, fe, log=log, profile="--profile" in argv)}
    t11 = time.perf_counter() - t0
    log(f"phase 11(a) ({t11:.1f} s) on {smi}")
    del dec
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        held = {}
        fres = facade(work, "cuda", log=log, hold=held)
        log(f"facade ({time.perf_counter() - t0:.1f} s) on {smi}: "
            + json.dumps(fres, default=float))
        t0 = time.perf_counter()
        dec3 = held.pop("decoder")
        mres = modes(work, "cuda", log=log, hmm=os.path.join(work, "hmm"),
                     dec3=dec3)
        log(f"phase 8 ({time.perf_counter() - t0:.1f} s) on {smi}: "
            + json.dumps(mres, default=float))
        t0 = time.perf_counter()
        # phase 7's decoder is 10(a)'s reference, over the same files
        cres = cli_20k(work, "cuda", log=log, hmm=os.path.join(work, "hmm"),
                       dec=dec3, cmn0=held.pop("cmn0"))[0]
        t1 = time.perf_counter()
        f20 = flat_20k(dec3, "cuda", log=log)
        del dec3
        t10 += time.perf_counter() - t0
        log(f"phase 10(a) ({t1 - t0:.1f} s), 10(c) "
            f"({time.perf_counter() - t1:.1f} s) on {smi}")
    with tempfile.TemporaryDirectory() as work:
        t9 = t0 = time.perf_counter()
        held = {}
        ref = reference_scale(work, "cuda", log=log,
                              profile="--profile" in argv, hold=held)
        log(f"phase 9(a-c) ({time.perf_counter() - t0:.1f} s) on {smi}: "
            + json.dumps(ref, default=float))
        # phase 11(b)-(d), tensor parallelism at 126k, on phase 9's decoder
        t1 = time.perf_counter()
        tp.update(tp_126k(held, en_us_frontend(), log=log,
                          profile="--profile" in argv,
                          modes="--profile" in argv))
        held.clear()
        t11 += time.perf_counter() - t1
        log(f"phase 11(b-d) ({time.perf_counter() - t1:.1f} s); phase 11 "
            f"{t11:.1f} s on {smi}")
        t9 += time.perf_counter() - t1
        t0 = time.perf_counter()
        batch_cli(work, "cuda", log=log)
        rows_res = rows_transitions(work, log=log)
        log(f"phase 9(e) ({time.perf_counter() - t0:.1f} s) on {smi}; "
            f"phase 9 {time.perf_counter() - t9 + top_s:.1f} s with (d)")
        t0 = time.perf_counter()
        hmm17 = os.path.join(work, "hmm_cli")        # phase 9(e)'s model
        cli_1k7(work, "cuda", log=log, hmm=hmm17)
        t1 = time.perf_counter()
        f17 = flat_1k7(work, "cuda", log=log, hmm=hmm17)
        t10 += time.perf_counter() - t0
        log(f"phase 10(a') ({t1 - t0:.1f} s), 10(b) "
            f"({time.perf_counter() - t1:.1f} s); phase 10 {t10:.1f} s "
            f"on {smi}")
    log(f"phase 10: cli single {cres['single']['seconds']:.2f} s, live "
        f"{cres['live']['seconds']:.2f} s at 20k (builds included); flat "
        f"1.7k B={f17['batch']} {f17['ms_per_frame']:.3f} ms/frame, peak "
        f"{f17['peak_mem_bytes'] / 2**30:.3f} GiB; flat 20k B=1 "
        f"{f20['b1_ms_per_frame']:.3f} ms/frame, peak "
        f"{f20['b1_peak_mem_bytes'] / 2**30:.3f} GiB (B=2 "
        f"{f20['b2_ms_per_frame']:.3f} ms/frame, peak "
        f"{f20['b2_peak_mem_bytes'] / 2**30:.3f} GiB); top-K guard counts "
        f"{[u['guard'] for u in topk['utts']]} on {smi}")
    co = ref["corpus"]
    log(f"126k: {co['audio_s_per_s']:.2f} audio-s/s (median of "
        f"{[round(r, 2) for r in co['runs']]}), scan "
        f"{co['median_run']['scan_ms_per_frame']:.2f} ms per B={B} frame, "
        f"peak memory {co['peak_mem_bytes'] / 2**30:.2f} GiB; "
        f"PS_GUARD_TOPM=64 at 20k: guard {top['guard_violations']} (GM=0: "
        f"{top['guard_violations_gm0']}), peak memory "
        f"{top['peak_mem_bytes'] / 2**30:.2f} GiB (GM=0: "
        f"{top['peak_mem_bytes_gm0'] / 2**30:.2f}) on {smi}")
    # the NST=5 group at the 5-state decode's B=1 (nst5_*), and at B=8
    nst5 = dict(nst5_launches=mres["nst5"]["launches"]["chain"])
    for B, pre in ((1, "nst5_"), (8, "nst5_b8_")):
        c5 = mres["chain5"][B]
        nst5.update({pre + k: c5[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "wrapper_ms", "bound_ms")})
    # the transition kernel in LM mode rows (1.7k; rows_*) and at 70 CI
    # phones (phones_*)
    rows = {"rows_" + k: rows_res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "wrapper_ms", "bound_ms", "E")}
    rows.update(phones_max_abs_err=ph_res["max_abs_err"],
                phones_launches=ph_res["launches"])
    kernels = []
    for name, r, src, rep in (
            ("fan", fan_res, "pocketsphinx_tpu_torch/csrc/fan.cu",
             "pocketsphinx_tpu/ops/pallas_fan.py:43"),
            ("chain", chain_res, "pocketsphinx_tpu_torch/csrc/chain.cu",
             "pocketsphinx_tpu/ops/pallas_chain.py:35"),
            ("transitions", tr_res,
             "pocketsphinx_tpu_torch/csrc/transitions.cu",
             "pocketsphinx_tpu/search/ngram_fused.py:1297")):
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep,
                            launches=res["launches"][name],
                            tp_launches=tp["a"]["launches"][name],
                            facade_launches=fres["launches"][name],
                            cli_launches=cres["single"]["launches"][name]
                            + cres["live"]["launches"][name],
                            library_ms=None, **r,
                            **(nst5 if name == "chain" else {}),
                            **(rows if name == "transitions" else {})))
    for k in kernels[:3]:              # the same kernels at the 126k shapes
        kernels.append(dict(
            k, name=k["name"] + "_126k", launches=co["launches"][k["name"]],
            tp_launches=sum(tp[x]["launches"][k["name"]] for x in "bcd"
                            if isinstance(tp[x], dict)),
            facade_launches=0, cli_launches=0, **ref[k["name"]]))
        for key in [x for x in k
                    if x.startswith(("nst5", "rows_", "phones_"))]:
            del kernels[-1][key]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
