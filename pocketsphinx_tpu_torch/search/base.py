"""What the grammar, keyword, allphone and align searches share: a device,
tables there built from their host arrays, and one utterance's senone
costs on it."""

from __future__ import annotations

import numpy as np
import torch

from ..models.acoustic import senone_scores


def host_to(device):
    """A function moving host arrays to `device` as tensors."""
    dev = torch.device(device)
    return lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)


class DeviceSearch:
    """A search whose per-frame step runs on `self.device` over the
    tensors `_device_tables(device)` makes from its host arrays (host
    code in subclasses stays the JAX package's)."""

    device: torch.device

    def _device_tables(self, device) -> dict:
        return {}

    def rebuild(self):
        """Rebuild the host network and the device tables after the
        dictionary changed (the JAX search's `_build`)."""
        self._build()
        self.tables = self._device_tables(self.device)

    def to(self, device):
        """A search sharing this one's host network, with its tables on
        `device` (e.g. to check a CUDA run against the CPU)."""
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other.device = torch.device(device)
        other.tables = self._device_tables(other.device)
        return other

    def utterance_costs(self, feats, costs=None):
        """One utterance's senone costs [T, n_sen] float32 on the device:
        `costs` as given, else scored from feats [T, F, L]."""
        if costs is None:
            x = torch.as_tensor(np.asarray(feats, np.float32)[None],
                                device=self.device)
            costs = senone_scores(self.am.scoring_tensors(self.device), x)[0]
        return torch.as_tensor(costs, device=self.device).to(torch.float32)

    @staticmethod
    def _run(step, carry, xs, T):
        """Step `T` frames, `carry, records = step(carry, *(x[t] for x in
        xs), t)`, writing each frame's records into [T, ...] buffers on
        the device (made at the first frame).  Returns (the buffers, their
        host copies): one copy per utterance, not a sync per frame."""
        recs = None
        for t in range(T):
            carry, rec = step(carry, *(x[t] for x in xs), t)
            if recs is None:
                recs = tuple(torch.empty((T,) + r.shape, dtype=r.dtype,
                                         device=r.device) for r in rec)
            for buf, r in zip(recs, rec):
                buf[t] = r
        return recs, tuple(r.cpu().numpy() for r in recs)
