"""Controller<->replica layer: the replica group behind the engines.

Port of ``ReplicaGroup`` from ``repro/core/replication.py`` with the
paper's policies: every write is mirrored to all healthy replicas
(``write_policy="all"``) and each read is served by one replica in
round-robin order (``read_policy="rr"``). The fused step (core/fused.py)
applies both inside the step; the host-dispatch backends call ``write``
and ``read``, which post WRITE and READ messages over the transport.
Control ops ride the transport to every healthy replica.
``engine.check_ported`` rejects the other policies: quorum/async/latency
and the streamed delta ``rebuild`` land with the transport slice.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.core import dbs
from repro_torch.core.transport import (MSG_CLONE, MSG_CREATE, MSG_DELETE,
                                        MSG_QUERY_REV, MSG_READ, MSG_SNAPSHOT,
                                        MSG_UNMAP, MSG_WRITE, Replica,
                                        WireMsg, make_transport)


class ReplicaGroup:
    """The controller's backend: mirrors control ops across replica
    transports, and hands the fused step every healthy replica's state,
    pool and watermarks."""

    def __init__(self, n_replicas: int, n_extents: int, max_volumes: int,
                 max_pages: int, page_blocks: int, payload_shape=(4,),
                 transport: str = "local", *, device):
        self.transport_name = transport
        # pools carry ONE extra extent row past the allocator's range: the
        # dump row that the write kernel parks inert lanes on.
        # dbs.make_state only ever hands out extents < n_extents.
        self.replicas: List[Replica] = [
            Replica(state=dbs.make_state(n_extents, max_volumes, max_pages,
                                         device=device),
                    pool=torch.zeros((n_extents + 1, page_blocks)
                                     + tuple(payload_shape),
                                     dtype=torch.float32, device=device),
                    page_rev=torch.zeros((max_volumes, max_pages),
                                         dtype=torch.int32, device=device))
            for _ in range(n_replicas)]
        self.transports = [make_transport(transport, r)
                           for r in self.replicas]
        self._rr = 0

    # -- control plane: mirrored to every healthy replica ---------------------
    def _mirror_ctl(self, op: int, **kw) -> Any:
        """Post one control message to every healthy replica and wait for
        all acks. Returns the first reply value (mirrored ops agree)."""
        msg = WireMsg(op=op, **kw)
        vals = [t.call(msg) for t, r in zip(self.transports, self.replicas)
                if r.healthy]
        return next((v for v in vals if v is not None), None)

    def create_volume(self) -> int:
        return int(self._mirror_ctl(MSG_CREATE))

    def snapshot(self, vol: int) -> int:
        return int(self._mirror_ctl(MSG_SNAPSHOT, volume=vol))

    def clone(self, vol: int) -> int:
        return int(self._mirror_ctl(MSG_CLONE, volume=vol))

    def unmap(self, vol: int, pages) -> None:
        dev = self.replicas[0].pool.device
        self._mirror_ctl(MSG_UNMAP, volume=vol, pages=torch.as_tensor(
            list(pages), dtype=torch.int64).to(dev))

    def delete_volume(self, vol: int) -> None:
        self._mirror_ctl(MSG_DELETE, volume=vol)

    # -- fused data plane (core/fused.py) ------------------------------------
    def healthy_indices(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas) if r.healthy]

    def device_state(self):
        """(states, pools) tuples for every healthy replica — what the fused
        step threads through; nothing is fetched."""
        idx = self.healthy_indices()
        return (tuple(self.replicas[i].state for i in idx),
                tuple(self.replicas[i].pool for i in idx))

    def set_device_state(self, states, pools) -> None:
        """Write back the fused step's outputs (healthy replicas, in the
        order ``device_state`` returned them)."""
        idx = self.healthy_indices()
        for i, st in zip(idx, states):
            self.replicas[i].state = st
        for i, pool in zip(idx, pools):
            self.replicas[i].pool = pool

    def device_page_revs(self):
        """Per-replica last-write watermark tensors, ``device_state``
        order."""
        return tuple(self.replicas[i].page_rev
                     for i in self.healthy_indices())

    def set_device_page_revs(self, page_revs) -> None:
        for i, pr in zip(self.healthy_indices(), page_revs):
            self.replicas[i].page_rev = pr

    def bump_rr(self) -> int:
        """Advance and return the round-robin read cursor (a host int, so
        the step picks its replica by plain indexing)."""
        rr = self._rr
        self._rr += 1
        return rr

    # -- host-dispatched data plane (the loop/slots backends) ---------------
    def write(self, vol, pages: torch.Tensor, block_offsets: torch.Tensor,
              payload: torch.Tensor, mask=None) -> None:
        """Mirror a batch of block writes to every healthy replica; the
        write completes when every one has executed it (policy ``all``).
        vol: scalar or (B,) volume ids; tensors on the replicas' device."""
        dev = self.replicas[0].pool.device
        bits = torch.ones((), dtype=torch.int64, device=dev) << \
            block_offsets.long()
        if mask is None:
            mask = torch.ones(pages.shape, dtype=torch.bool, device=dev)
        msg = WireMsg(op=MSG_WRITE, volume=vol, pages=pages,
                      blocks=block_offsets, bits=bits, payload=payload,
                      mask=mask)
        for t, r in zip(self.transports, self.replicas):
            if r.healthy:
                t.call(msg)

    def _pick_replica(self) -> int:
        """Round-robin over the healthy set: the cursor advances once per
        read, and a failed replica's turn passes to the next healthy one."""
        n = len(self.replicas)
        order = [(self._rr + i) % n for i in range(n)]
        self._rr += 1
        for i in order:
            if self.replicas[i].healthy:
                return i
        raise RuntimeError("no healthy replica")

    def read(self, vol, pages: torch.Tensor,
             block_offsets: torch.Tensor) -> torch.Tensor:
        """Read one block per lane from the replica the rr policy picks:
        (B, *payload) on the device, holes as zeros. vol: scalar or
        (B,)."""
        i = self._pick_replica()
        return self.transports[i].call(WireMsg(
            op=MSG_READ, volume=vol, pages=pages, blocks=block_offsets))

    def drain_transports(self) -> None:
        for t in self.transports:
            t.drain()

    # -- fault handling ------------------------------------------------------
    def _check_index(self, idx: int) -> None:
        if not 0 <= idx < len(self.replicas):
            raise IndexError(f"replica index {idx} out of range "
                             f"[0, {len(self.replicas)})")

    def fail(self, idx: int) -> None:
        """Mark a replica faulty and tear down its link. The controller
        never declares the LAST healthy replica dead (volume loss)."""
        self._check_index(idx)
        survivors = [r for i, r in enumerate(self.replicas)
                     if r.healthy and i != idx]
        if self.replicas[idx].healthy and not survivors:
            raise RuntimeError(f"replica {idx} is the last healthy replica; "
                               "failing it would lose the volume")
        self.replicas[idx].healthy = False
        self.transports[idx].cancel_pending()

    def consistent(self) -> bool:
        """Healthy replicas agree on the metadata revision (the revisions
        come back in ONE host fetch)."""
        revs = torch.stack([
            t.call(WireMsg(op=MSG_QUERY_REV))
            for t, r in zip(self.transports, self.replicas) if r.healthy
        ]).tolist()
        return len(set(revs)) == 1

    def rebuild(self, idx: int) -> None:
        raise ValueError("ReplicaGroup.rebuild (the streamed delta rebuild) "
                         "lands with the transport slice of the port")
