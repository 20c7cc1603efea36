"""The elastic and sharded runs' large collectives over NCCL, for workers
that each have a CUDA card of their own (``staging.make_exchange`` chooses
it; several workers on one card, or the CPU, take the shared host slots of
``staging.py``, since NCCL refuses two ranks on one card).

The methods are :class:`~repro_torch.distributed.staging.HostExchange`'s,
and so are the results, bit for bit: every collective here is a copy of
bytes (``all_gather_into_tensor``, ``broadcast``, ``all_to_all_single``), never a reduce, whose
sum would follow NCCL's order; the sums stay the callers' canonical trees
(the tensor-parallel boundaries' sum and reduce-scatter too,
``staging.GroupCollectives``, over these all-gathers and all-to-alls).
The groups are prefixes of the world (``launch.mesh.prefix_widths``), where
a group rank is the global rank, and the run's axis groups
(``launch.mesh.make_axis_groups``: one NCCL group each, made by
:meth:`DeviceExchange.add_group`), where a group rank is a position in
``mesh.ranks``. A collective returns once it is enqueued:
NCCL runs it on its own stream, the caller's stream waits for it on the
device, and the host runs ahead as it does for compute (the sharded step
makes several collectives a layer, and a wait for the stream after each
would serialize the host's work and the card's). :class:`StagingTimes`
holds the host seconds of the calls (under ``collective_s``; there is no
host copy). ``backend`` is NCCL on the card; the CPU tests run the same
code over gloo.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.distributed.staging import GroupCollectives, StagingTimes, _bytes, place_shards, slice_position


class DeviceExchange(GroupCollectives):
    def __init__(self, rank: int, world: int, device: torch.device, backend: str = "nccl"):
        import torch.distributed as dist

        from repro_torch.launch.mesh import prefix_widths

        self.rank, self.world, self.device, self.backend = rank, world, torch.device(device), backend
        self.groups = {w: dist.new_group(ranks=list(range(w)), backend=backend) for w in prefix_widths(world)}
        # a first collective, so that a NCCL that cannot start fails here and not mid-step
        probe = torch.full((1,), rank, dtype=torch.uint8, device=self.device)
        seen = torch.empty(world, dtype=torch.uint8, device=self.device)
        dist.all_gather_into_tensor(seen, probe, group=self.groups[world])
        if seen.tolist() != list(range(world)):
            raise RuntimeError(f"NCCL's first all-gather returned {seen.tolist()}")
        self.axis_groups: dict = {}  # global ranks -> the NCCL group over them

    def add_group(self, ranks: tuple) -> None:
        """An NCCL group over ``ranks`` (every rank of the run calls it, in one order)."""
        import torch.distributed as dist

        self.axis_groups[tuple(ranks)] = dist.new_group(ranks=list(ranks), backend=self.backend)

    def _pg(self, mesh):
        """The process group of ``mesh``: a prefix of the world, or an axis group."""
        if isinstance(mesh.ranks, range):
            return self.groups[mesh.width]
        return self.axis_groups[tuple(mesh.ranks)]

    def _timed(self, fn, times: StagingTimes):
        t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
        fn()
        times.collective_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only

    def all_gather(self, tensors: List[Optional[torch.Tensor]], mesh, times: StagingTimes,
                   consume: bool = False, senders: Optional[int] = None) -> Iterator[Tuple[int, List[torch.Tensor]]]:
        """As ``HostExchange.all_gather``: the views are on this card."""
        import torch.distributed as dist

        width = mesh.width
        senders = width if senders is None else senders
        sends = mesh.index(self.rank) < senders
        for i, t in enumerate(tensors):
            n = t.numel() * t.element_size()
            src = _bytes(t) if sends else torch.empty(n, dtype=torch.uint8, device=self.device)
            if consume:
                tensors[i] = t = None
            out = torch.empty(width * n, dtype=torch.uint8, device=self.device)
            self._timed(lambda: dist.all_gather_into_tensor(out, src, group=self._pg(mesh)), times)
            del src
            yield i, [out[d * n:(d + 1) * n] for d in range(senders)]

    @torch.no_grad()
    def broadcast(self, tensors: List[torch.Tensor], mesh, times: StagingTimes) -> None:
        """As ``HostExchange.broadcast``, in place."""
        import torch.distributed as dist

        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("a broadcast tensor must be contiguous")
            self._timed(lambda: dist.broadcast(_bytes(t), 0, group=self.groups[mesh.width]), times)

    def assemble(self, shards: List[Optional[torch.Tensor]], shardings: list, likes: List[torch.Tensor],
                 mesh, times: StagingTimes, device, want: bool = True) -> Iterator[Tuple[int, Optional[torch.Tensor]]]:
        """As ``HostExchange.assemble``: a leaf with one holder by a
        broadcast from it, any other by an all-gather of every rank's shard
        (a rank that holds no shard of it sends an unused buffer)."""
        import torch.distributed as dist

        group = self._pg(mesh)
        for i, (shard, sharding, like) in enumerate(zip(shards, shardings, likes)):
            shard_like = torch.empty(sharding.shard_shape, dtype=like.dtype, device="meta")
            n = shard_like.numel() * shard_like.element_size()
            holders = sharding.holders()
            if len(holders) == 1:
                holder = next(iter(holders.values()))
                buf = _bytes(shard) if shard is not None else torch.empty(n, dtype=torch.uint8,
                                                                                  device=self.device)
                self._timed(lambda: dist.broadcast(buf, mesh.ranks[holder], group=group), times)
                parts = {index: buf for index in holders}
            else:
                src = _bytes(shard) if shard is not None else torch.empty(n, dtype=torch.uint8, device=self.device)
                out = torch.empty(mesh.width * n, dtype=torch.uint8, device=self.device)
                self._timed(lambda: dist.all_gather_into_tensor(out, src, group=group), times)
                parts = {index: out[h * n:(h + 1) * n] for index, h in holders.items()}
            yield i, place_shards(parts, sharding, like, shard_like, times, device) if want else None

    def _to_all(self, inp: Optional[torch.Tensor], in_splits: List[int], recvs: dict, mesh,
                times: StagingTimes) -> dict:
        """One ``all_to_all_single`` over the mesh's group: ``inp`` (bytes,
        or None for nothing) in ``in_splits`` a position, ``recvs`` position
        -> the byte count this rank receives from it; returns position ->
        the received bytes (views)."""
        import torch.distributed as dist

        width = mesh.width
        out_splits = [recvs.get(q, 0) for q in range(width)]
        inp = torch.empty(0, dtype=torch.uint8, device=self.device) if inp is None else inp
        out = torch.empty(sum(out_splits), dtype=torch.uint8, device=self.device)
        self._timed(lambda: dist.all_to_all_single(out, inp, out_splits, in_splits, group=self._pg(mesh)), times)
        got, at = {}, 0
        for q, n in enumerate(out_splits):
            if q in recvs:
                got[q] = out[at:at + n]
            at += n
        return got

    def exchange_slices(self, tensors: List[Optional[torch.Tensor]], shardings: list, likes: List[torch.Tensor],
                        mesh, times: StagingTimes, senders: int) -> Iterator[Tuple[int, List[torch.Tensor]]]:
        """As ``HostExchange.exchange_slices``, one ``all_to_all_single`` a
        leaf: a sender copies, for each rank, the slice of the shard index
        it stores into one buffer, drops its leaf, and sends; the views are
        on this card."""
        width, sends = mesh.width, mesh.index(self.rank) < senders
        for i, (sharding, like) in enumerate(zip(shardings, likes)):
            size = like.numel() * like.element_size() // sharding.num_shards
            inp, in_splits = None, [0] * width
            if sends:
                t, indices = tensors[i], list(sharding.holders())
                inp = torch.empty(width * size, dtype=torch.uint8, device=self.device)
                for q in range(width):
                    part = t[sharding.slices_of(indices[slice_position(sharding, q)])]
                    inp[q * size:(q + 1) * size].view(like.dtype).view(part.shape).copy_(part)
                in_splits = [size] * width
                del t
            tensors[i] = None
            got = self._to_all(inp, in_splits, {d: size for d in range(senders)}, mesh, times)
            del inp
            yield i, [got[d] for d in range(senders)]

    def assemble_at(self, shards: List[Optional[torch.Tensor]], shardings: list, likes: List[torch.Tensor],
                    owners: List[int], mesh, times: StagingTimes,
                    device) -> Iterator[Tuple[int, Optional[torch.Tensor]]]:
        """As ``HostExchange.assemble_at``: each holder sends its shard to
        the leaf's owner alone (one ``all_to_all_single`` a leaf)."""
        for i, (shard, sharding, like) in enumerate(zip(shards, shardings, likes)):
            shard_like = torch.empty(sharding.shard_shape, dtype=like.dtype, device="meta")
            n = shard_like.numel() * shard_like.element_size()
            holders = sharding.holders()
            in_splits = [n if shard is not None and q == owners[i] else 0 for q in range(mesh.width)]
            recvs = {h: n for h in holders.values()} if owners[i] == self.rank else {}
            got = self._to_all(_bytes(shard) if shard is not None else None, in_splits, recvs, mesh, times)
            if owners[i] != self.rank:
                yield i, None
                continue
            parts = {index: got[h] for index, h in holders.items()}
            yield i, place_shards(parts, sharding, like, shard_like, times, device)

    def to_all(self, sends: List[Optional[torch.Tensor]], recv_likes: dict, mesh, times: StagingTimes,
               device) -> dict:
        """As ``HostExchange.to_all``, one ``all_to_all_single``; the
        received tensors are views on this card."""
        inp = [_bytes(t) for t in sends if t is not None]
        in_splits = [0 if t is None else t.numel() * t.element_size() for t in sends]
        in_splits += [0] * (mesh.width - len(in_splits))
        recvs = {p: like.numel() * like.element_size() for p, like in recv_likes.items()}
        got = self._to_all(torch.cat(inp) if inp else None, in_splits, recvs, mesh, times)
        return {p: got[p].view(like.dtype).reshape(like.shape) for p, like in recv_likes.items()}
