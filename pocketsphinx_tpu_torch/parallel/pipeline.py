"""Pipeline parallelism: stage the decode across two devices.

Port of `pocketsphinx_tpu.parallel.pipeline`.  Two stages, the natural
cut for this workload:

  stage 0 (`dev_score`): PCM -> MFCC -> features -> dense senone scoring
                         (GEMM-heavy, stateless per frame)
  stage 1 (`dev_scan`):  the fused Viterbi scan (sequential in T) and
                         the backtrace

Micro-batches flow from stage 0 to stage 1: the next micro-batch's
stage 0 is started before this one's scan, so on two cards it runs while
the host drives the scan, and the costs hop devices with `.to`.  With
one card both stages share it.  Hypotheses equal single-device decoding
(the stages are the same functions).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend.feat import batch_features
from .batch import replicas


class TwoStagePipeline:
    """Frontend and scoring on one device, the Viterbi scan on another
    (both default to the search's device, or to the first two CUDA cards
    when there are two)."""

    def __init__(self, decoder_search, frontend, dev_score=None,
                 dev_scan=None, cmn: str = "batch"):
        dev = decoder_search.device
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])
        self.search = decoder_search
        self.fe = frontend
        self.dev_score = torch.device(dev_score or devs[0])
        self.dev_scan = torch.device(dev_scan or devs[min(1, len(devs) - 1)])
        self.cmn = cmn
        fp = decoder_search.am.feat_params
        self.features = batch_features(fp["feat"], fp["svspec"])
        self.scan_search = replicas(decoder_search, [[self.dev_scan]])[0]

    def _stage_score(self, pcm_batch, n_samps):
        from ..models.acoustic import senone_scores
        cep, nfr = self.fe.process_batch(pcm_batch, n_samps,
                                         device=self.dev_score)
        feats = self.features(cep, nfr, cmn=self.cmn)
        # in decode_batch's time chunks: the same GEMM shapes, so the same
        # costs as `BatchDecodePipeline`
        return senone_scores(self.search.am.scoring_tensors(self.dev_score),
                             feats, time_chunk=16), nfr

    def decode_corpus(self, pcm_list, micro_batch: int = 8):
        """Decode utterances in micro-batches pipelined across the two
        devices; returns [(hyp, segs)] in input order."""
        order = sorted(range(len(pcm_list)), key=lambda i: len(pcm_list[i]))
        results = [None] * len(pcm_list)
        groups = [order[i0:i0 + micro_batch]
                  for i0 in range(0, len(order), micro_batch)]

        def score(idx):
            batch = np.zeros((len(idx), max(len(pcm_list[i]) for i in idx)),
                             np.float32)
            for k, i in enumerate(idx):
                batch[k, :len(pcm_list[i])] = pcm_list[i]
            ns = np.array([len(pcm_list[i]) for i in idx], np.int32)
            return self._stage_score(batch, ns)

        ahead = score(groups[0]) if groups else None
        for g, idx in enumerate(groups):
            costs, nfr = ahead
            costs = costs.to(self.dev_scan)
            if g + 1 < len(groups):       # stage 0 of the next micro-batch
                ahead = score(groups[g + 1])
            out = self.scan_search.decode_batch(
                None, nfr.cpu(), keep_records=False, costs=costs)
            for k, i in enumerate(idx):
                results[i] = out[k]
        return results
