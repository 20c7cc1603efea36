"""Host-staged collectives over shared host slots, for the workers of one
elastic run.

The workers of a run are processes on one host (``ElasticTrainer.run``
spawns them), so their large collectives go through shared host memory:
each rank owns a slot, a file in the run's directory that every worker maps
(``torch.from_file(..., shared=True)``), as large as the largest leaf. A
collective copies this rank's tensors to the host into its slot, meets the
other ranks at a gloo barrier, copies what it needs from their slots back
to its device, and meets them at a barrier again before the slots are
reused. The copies are explicit and named; gloo carries the barriers and
the control traffic. gloo's own ``all_gather`` over the loopback is 4-6x
slower for the same partials on an H100 host (``tools/elastic_bench.py``
times both); a slot costs a copy out and a copy back, and no socket.

Tensors travel as their bytes, so any dtype goes through bit for bit, and
they go in buckets that fill a slot, so the host holds at most W slots of
the largest leaf's size (the largest at qwen2.5-3b's full width is the
311 M-element tied embedding, 1.24 GB in f32). :class:`StagingTimes` adds
up the host seconds of the three parts: the copy out, the barrier, the
copy back.

Besides the all-gather, the broadcast and the shard gather, the sharded
step's gradient moves as slices (:meth:`HostExchange.exchange_slices`):
each sender writes a leaf's slices into its slot in shard-index order, and
each rank copies back, from every sender, the slice of the shard index it
stores (a reduce-scatter's traffic as an all-to-all; the caller sums).

Every collective runs over a mesh of the run's ranks: a
:class:`~repro_torch.launch.mesh.DataMesh` (ranks ``[0, W)``) or an axis
group (:class:`~repro_torch.launch.mesh.GroupMesh`), whose positions map to
ranks, and so to slots, through ``mesh.ranks``; its barriers are the
group's. :meth:`HostExchange.to_all` is the MoE layer's all-to-all over a
``model`` group: each rank writes its blocks into its slot in position
order and reads, from each sender, the block of its own position.

Tensor parallelism's boundaries (``sharded.py``'s ``_TensorGroup``) add
three collectives over a ``model`` group, :class:`GroupCollectives`, which
both routes inherit: an all-gather (along the sequence, or of a few
scalars), a reduce-scatter along the sequence (an all-to-all of the blocks
and their sum by the canonical tree in position order) and a sum (an
all-reduce: that reduce-scatter, then an all-gather of the summed blocks).
Their sums' bits depend neither on timing nor on the route.

When every worker has a card of its own, the same collectives go through
NCCL instead (:class:`repro_torch.distributed.nccl.DeviceExchange`, the
same methods): :func:`make_exchange` chooses by the run's devices.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch

ALIGN = 64  # bytes: every tensor starts at an aligned offset of its slot


@dataclass
class StagingTimes:
    """Host seconds of a collective's parts, and the bytes received."""

    copy_out_s: float = 0.0
    collective_s: float = 0.0
    copy_back_s: float = 0.0
    received_bytes: int = 0  # bytes this rank copied back (from_host): what it received


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _padded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def from_host(buf: torch.Tensor, like: torch.Tensor, times: StagingTimes, device=None) -> torch.Tensor:
    """A new tensor of ``like``'s dtype and shape on ``device`` (default:
    ``like``'s; ``like`` may be a meta tensor) whose bytes are ``buf``'s."""
    t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
    out = buf.to(like.device if device is None else device, copy=True).view(like.dtype).reshape(like.shape)
    times.copy_back_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
    times.received_bytes += buf.numel() * buf.element_size()
    return out


def place_shards(parts: dict, sharding, like: torch.Tensor, shard_like: torch.Tensor, times: StagingTimes,
                 device) -> torch.Tensor:
    """The leaf from ``parts`` (shard index -> the shard's bytes, anywhere)."""
    if len(parts) == 1:
        return from_host(next(iter(parts.values())), like, times, device)
    full = torch.empty(like.shape, dtype=like.dtype, device=device)
    for index, buf in parts.items():
        full[sharding.slices_of(index)] = from_host(buf, shard_like, times, device)
    return full


def slice_position(sharding, rank: int) -> int:
    """The position of ``rank``'s shard index among the leaf's shard indices
    in index order: where its slice sits in a sender's slices."""
    return list(sharding.holders()).index(sharding.shard_index(rank))


class GroupCollectives:
    """The tensor-parallel boundaries' collectives over an axis group
    ``mesh`` (a ``model`` group), built on the exchange's ``all_gather``
    and ``to_all``: each rank passes tensors of one shape and dtype, and
    every rank of the group gets the same bits."""

    def group_all_gather(self, t: torch.Tensor, mesh, times: StagingTimes, device) -> List[torch.Tensor]:
        """Every position's ``t``, in position order, as new tensors on ``device``."""
        like = torch.empty(t.shape, dtype=t.dtype, device="meta")
        parts: List[torch.Tensor] = []
        for _, got in self.all_gather([t], mesh, times):
            parts = [from_host(b, like, times, device) for b in got]
        return parts

    def group_sum(self, t: torch.Tensor, mesh, times: StagingTimes, device) -> torch.Tensor:
        """The sum of every position's ``t`` (an all-reduce): its elements,
        padded to M blocks, reduce-scattered (:meth:`seq_reduce_scatter`)
        and the summed blocks all-gathered, a ring's bytes (2 x shape); in
        pieces of M x :meth:`_block_elements` where a route bounds a block
        (elementwise, the same bits and bytes)."""
        m, n = mesh.width, t.numel()
        c = -(-n // m)
        flat = t.reshape(1, n)
        if m * c > n:
            flat = torch.cat([flat, flat.new_zeros((1, m * c - n))], dim=1)
        step = self._block_elements(m, t.element_size()) or c
        sums = []
        for lo in range(0, m * c, m * step):
            mine = self.seq_reduce_scatter(flat[:, lo:lo + m * step], mesh, times, device)
            sums.append(torch.cat(self.group_all_gather(mine, mesh, times, device), dim=1))
        return torch.cat(sums, dim=1)[0, :n].reshape(t.shape)

    def _block_elements(self, m: int, itemsize: int) -> Optional[int]:
        """The most elements of a block one all-to-all of M blocks carries
        (None: no bound)."""
        return None

    def seq_reduce_scatter(self, t: torch.Tensor, mesh, times: StagingTimes, device) -> torch.Tensor:
        """``t`` (B, M c, ...) summed over the group's M positions, this
        position's block (B, c, ...) of it (a reduce-scatter along dimension
        1): block q of every rank to position q, added by the canonical tree
        in position order. Elementwise, the bits of :meth:`group_sum`'s
        block."""
        from repro_torch.distributed.step import add_, span_tree_sum

        m = mesh.width
        c = t.shape[1] // m
        sends = [t[:, q * c:(q + 1) * c].contiguous() for q in range(m)]
        like = torch.empty(sends[0].shape, dtype=t.dtype, device="meta")
        got = self.to_all(sends, {p: like for p in range(m)}, mesh, times, device)
        return span_tree_sum(lambda p: got[p], m, add_)


def make_exchange(directory: str, rank: int, world: int, slot_bytes: int, devices: list):
    """The run's collectives: NCCL (:class:`~repro_torch.distributed.nccl.DeviceExchange`)
    where the ``world`` workers each have a CUDA card of their own, else the
    shared host slots. Every rank calls it together. There is no fallback:
    when NCCL is chosen and fails, the run fails."""
    first = [torch.device(d) for d in devices[:world]]
    if all(d.type == "cuda" for d in first) and len({d.index for d in first}) == world:
        from repro_torch.distributed.nccl import DeviceExchange

        return DeviceExchange(rank, world, first[rank])
    return HostExchange(directory, rank, world, slot_bytes)


class HostExchange(GroupCollectives):
    """One slot of ``slot_bytes`` a rank, in ``directory``, mapped by every
    worker of the run; created by rank r for slot r, then a barrier of the
    default group (every rank calls the constructor together)."""

    def __init__(self, directory: str, rank: int, world: int, slot_bytes: int):
        import torch.distributed as dist

        self.rank, self.world, self.slot_bytes = rank, world, _padded(slot_bytes)
        path = lambda r: os.path.join(directory, f"slot_{r}")  # noqa: E731
        own = torch.from_file(path(rank), shared=True, size=self.slot_bytes, dtype=torch.uint8)
        if world > 1:
            dist.barrier()
        self.slots = [own if r == rank else torch.from_file(path(r), shared=True, size=self.slot_bytes,
                                                            dtype=torch.uint8)
                      for r in range(world)]

    def _block_elements(self, m: int, itemsize: int) -> Optional[int]:
        """M blocks of one all-to-all fit the slot, each at an aligned stride."""
        return max(1, self.slot_bytes // m // ALIGN * ALIGN // itemsize)

    def _buckets(self, tensors: List[torch.Tensor]) -> List[List[Tuple[int, int, int]]]:
        """Runs of (index, offset, bytes) that fill a slot, in order."""
        buckets, used = [[]], 0
        for i, t in enumerate(tensors):
            n = t.numel() * t.element_size()
            if n > self.slot_bytes:
                raise ValueError(f"a tensor of {n} bytes exceeds the host slot ({self.slot_bytes} bytes)")
            if used + n > self.slot_bytes:
                buckets.append([])
                used = 0
            buckets[-1].append((i, used, n))
            used += _padded(n)
        return [b for b in buckets if b]

    def _barrier(self, mesh, times: StagingTimes) -> None:
        import torch.distributed as dist

        t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
        dist.barrier(group=mesh.group)
        times.collective_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only

    def all_gather(self, tensors: List[Optional[torch.Tensor]], mesh, times: StagingTimes,
                   consume: bool = False, senders: Optional[int] = None) -> Iterator[Tuple[int, List[torch.Tensor]]]:
        """For each tensor, in order: (its index, the bytes of it of ranks
        ``[0, senders)`` (default: every rank of the mesh) on the host, in
        rank order), on every rank of the mesh. Every rank passes tensors of
        the same shapes and dtypes; a rank that does not send passes meta
        tensors. A rank's views hold until it asks for the next item; the
        caller must exhaust the iterator. ``consume`` drops each entry of
        ``tensors`` once its bytes are on the host."""
        senders = mesh.width if senders is None else senders
        sends = mesh.index(self.rank) < senders
        for bucket in self._buckets(tensors):
            t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
            own = self.slots[self.rank]
            for i, off, n in bucket:
                if sends:
                    own[off:off + n].copy_(_bytes(tensors[i]))
                if consume:
                    tensors[i] = None
            times.copy_out_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
            self._barrier(mesh, times)
            for i, off, n in bucket:
                yield i, [self.slots[mesh.ranks[d]][off:off + n] for d in range(senders)]
            self._barrier(mesh, times)  # every rank has read the slots

    def assemble(self, shards: List[Optional[torch.Tensor]], shardings: list, likes: List[torch.Tensor],
                 mesh, times: StagingTimes, device, want=True) -> Iterator[Tuple[int, Optional[torch.Tensor]]]:
        """Whole leaves from their shards, leaf by leaf, on every rank of the
        mesh: (index, the leaf on ``device``, or None where not ``want``: a
        bool, or one a leaf).
        ``shards[i]`` is this rank's shard of leaf i where it is the holder
        of its shard index (the lowest rank storing it: it sends), else
        None; ``shardings[i]`` places the leaf on a mesh whose ranks are a
        prefix of this one's; ``likes[i]`` has its shape and dtype (a meta
        tensor). Copies only: a leaf has its shards' bits."""
        shard_likes = [torch.empty(s.shard_shape, dtype=like.dtype, device="meta")
                       for s, like in zip(shardings, likes)]
        for bucket in self._buckets(shard_likes):
            t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
            own = self.slots[self.rank]
            for i, off, n in bucket:
                if shards[i] is not None:
                    own[off:off + n].copy_(_bytes(shards[i]))
            times.copy_out_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
            self._barrier(mesh, times)
            for i, off, n in bucket:
                if not (want if isinstance(want, bool) else want[i]):
                    yield i, None
                    continue
                parts = {index: self.slots[mesh.ranks[holder]][off:off + n]
                         for index, holder in shardings[i].holders().items()}
                yield i, place_shards(parts, shardings[i], likes[i], shard_likes[i], times, device)
            self._barrier(mesh, times)

    def assemble_at(self, shards: List[Optional[torch.Tensor]], shardings: list, likes: List[torch.Tensor],
                    owners: List[int], mesh, times: StagingTimes,
                    device) -> Iterator[Tuple[int, Optional[torch.Tensor]]]:
        """As :meth:`assemble`, each leaf whole on its owner's rank only
        (``owners[i]``; None elsewhere)."""
        yield from self.assemble(shards, shardings, likes, mesh, times, device,
                                 want=[o == self.rank for o in owners])

    def exchange_slices(self, tensors: List[Optional[torch.Tensor]], shardings: list, likes: List[torch.Tensor],
                        mesh, times: StagingTimes, senders: int) -> Iterator[Tuple[int, List[torch.Tensor]]]:
        """For each leaf, in order: (its index, the bytes of the slice of it
        that this rank stores, from each rank of ``[0, senders)`` in rank
        order, on the host), on every rank of the mesh. ``tensors[i]`` is
        this rank's whole leaf where it sends, else None, and is dropped
        once its bytes are on the host; ``likes[i]`` has the leaf's shape
        and dtype (a meta tensor); ``shardings[i]`` places it on a mesh whose
        ranks are this one's. Nothing is summed in transit. A rank's views
        hold until it asks for the next item; the caller must exhaust the
        iterator."""
        me = mesh.index(self.rank)
        sends = me < senders
        for bucket in self._buckets(likes):
            t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
            own = self.slots[self.rank]
            for i, off, n in bucket:
                if sends:
                    sharding = shardings[i]
                    size = n // sharding.num_shards
                    for j, index in enumerate(sharding.holders()):
                        own[off + j * size:off + (j + 1) * size].copy_(_bytes(tensors[i][sharding.slices_of(index)]))
                tensors[i] = None
            times.copy_out_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
            self._barrier(mesh, times)
            for i, off, n in bucket:
                size = n // shardings[i].num_shards
                at = off + slice_position(shardings[i], me) * size
                yield i, [self.slots[mesh.ranks[d]][at:at + size] for d in range(senders)]
            self._barrier(mesh, times)

    def to_all(self, sends: List[Optional[torch.Tensor]], recv_likes: dict, mesh, times: StagingTimes,
               device) -> dict:
        """An all-to-all over ``mesh``: ``sends[q]`` (None for nothing) goes
        to position q, every block of one call of one size; returns position
        -> the tensor received from it (``recv_likes[p]``'s shape and dtype,
        on ``device``) for each position p of ``recv_likes``. Blocks are
        copies of bytes."""
        sizes = {t.numel() * t.element_size() for t in [t for t in sends if t is not None] + list(recv_likes.values())}
        if len(sizes) > 1:
            raise ValueError(f"an all-to-all's blocks differ in size: {sorted(sizes)}")
        stride = _padded(sizes.pop()) if sizes else 0
        if stride * mesh.width > self.slot_bytes:
            raise ValueError(f"an all-to-all of {mesh.width} blocks of {stride} bytes exceeds the host slot "
                             f"({self.slot_bytes} bytes)")
        t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
        own = self.slots[self.rank]
        for q, t in enumerate(sends):
            if t is not None:
                b = _bytes(t)
                own[q * stride:q * stride + b.numel()].copy_(b)
        times.copy_out_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
        self._barrier(mesh, times)
        me = mesh.index(self.rank)
        got = {}
        for p, like in recv_likes.items():
            n = like.numel() * like.element_size()
            got[p] = from_host(self.slots[mesh.ranks[p]][me * stride:me * stride + n], like, times, device)
        self._barrier(mesh, times)
        return got

    @torch.no_grad()
    def broadcast(self, tensors: List[torch.Tensor], mesh, times: StagingTimes) -> None:
        """Rank 0's bytes of each tensor into that tensor on every rank of the mesh."""
        for bucket in self._buckets(tensors):
            if self.rank == 0:
                t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
                for i, off, n in bucket:
                    self.slots[0][off:off + n].copy_(_bytes(tensors[i]))
                times.copy_out_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
            self._barrier(mesh, times)
            if self.rank != 0:
                for i, off, n in bucket:
                    t = tensors[i]
                    t.copy_(from_host(self.slots[0][off:off + n], t, times))
            self._barrier(mesh, times)
