"""Sequence parallelism: one long trace split over the mesh's time axis.

The counterpart of ``kafkastreams_cep_tpu/parallel/seqpar.py``.  A strict
sequence of ``n`` stages completes at event ``t`` iff stage ``i`` accepts
event ``t-n+1+i``, so a match reads only the ``n`` events ending at ``t``
(``engine/stencil.py``): the time axis shards.  Each shard evaluates its
``[K, T/n_dev]`` chunk's predicate booleans on its device and receives the
previous shard's trailing ``n-1`` boolean and offset columns, the JAX
package's one-hop ``ppermute`` halo, here a copy onto the next shard's
device.  Shard 0's halo is zeros: "no preceding events", so a fresh trace
needs no special case.
"""

from __future__ import annotations

from typing import List

import torch

from kafkastreams_cep_tpu_torch.engine.matcher import ArrayStates, EventBatch
from kafkastreams_cep_tpu_torch.engine.stencil import StencilMatcher, StencilOutput
from kafkastreams_cep_tpu_torch.parallel.sharding import Mesh, _tree_map

I32 = torch.int32


class TimeShardedStencil:
    """Strict-sequence matching with the time axis sharded over a mesh.

    ``match(events)`` takes a ``[K, T]`` batch with ``T`` divisible by the
    mesh size (padding slots masked by ``valid``, as in the single-device
    scan); every shard stencils its own ``T/n_dev`` chunk after one
    boundary exchange.  The outputs, gathered on the first shard's device,
    have the shapes of :class:`StencilMatcher`'s scan of the same batch
    from its initial state, and equal it in ``hit`` and, where ``hit``, in
    ``offs``."""

    def __init__(self, pattern, num_lanes: int, mesh: Mesh):
        self.inner = StencilMatcher(pattern, num_lanes, device=mesh.devices[0])
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_dev = mesh.size
        self.num_lanes = int(num_lanes)

    def shard_events(self, events: EventBatch) -> List[EventBatch]:
        """A ``[K, T]`` batch as one time chunk a shard, each on its
        shard's device."""
        T = events.ts.shape[-1]
        if T % self.n_dev:
            raise ValueError(f"time axis {T} not divisible by mesh size {self.n_dev}")
        Tc = T // self.n_dev
        return [_tree_map(lambda x, s=s, d=d: x[:, s * Tc:(s + 1) * Tc].to(d), events)
                for s, d in enumerate(self.mesh.devices)]

    def _chunk(self, ev: EventBatch):
        """One chunk's per-stage booleans ``[K, Tc, n]`` and offsets."""
        K, Tc = ev.ts.shape
        dev = ev.ts.device
        valid = ev.valid.to(torch.bool)
        empty = ArrayStates({})
        bools = torch.stack(
            [torch.as_tensor(p(ev.key, ev.value, ev.ts, empty), device=dev)
             .to(torch.bool).expand(K, Tc) & valid
             for p in self.inner._preds],
            dim=-1,
        )
        return bools, ev.off.to(I32)

    def match(self, events) -> StencilOutput:
        """Every completed match of a ``[K, T]`` batch (or of its
        :meth:`shard_events`)."""
        parts = events if isinstance(events, list) else self.shard_events(events)
        n = self.inner.n
        dev0 = self.mesh.devices[0]
        hits, offs_out = [], []
        prev = None
        for ev in parts:
            bools, offs = self._chunk(ev)
            Tc = bools.shape[1]
            if n == 1:
                hits.append(bools[..., 0].to(dev0))
                offs_out.append(offs[..., None].to(dev0))
                continue
            if Tc < n - 1:
                raise ValueError(f"time chunk {Tc} is shorter than the {n - 1}-event halo")
            if prev is None:
                halo_b = torch.zeros_like(bools[:, :n - 1])
                halo_o = torch.zeros_like(offs[:, :n - 1])
            else:
                halo_b, halo_o = (x.to(bools.device) for x in prev)
            prev = (bools[:, Tc - (n - 1):], offs[:, Tc - (n - 1):])
            ext_b = torch.cat([halo_b, bools], dim=1)  # [K, Tc+n-1, n]
            ext_o = torch.cat([halo_o, offs], dim=1)
            hit = ext_b[:, 0:Tc, 0]
            for i in range(1, n):
                hit = hit & ext_b[:, i:i + Tc, i]
            hits.append(hit.to(dev0))
            offs_out.append(torch.stack([ext_o[:, i:i + Tc] for i in range(n)], dim=-1).to(dev0))
        return StencilOutput(hit=torch.cat(hits, dim=1), offs=torch.cat(offs_out, dim=1))
