"""Rule-based storage sharding over worker processes: ZeRO-style shards
between updates, whole leaves inside a step.

Between updates a worker stores only its shards of the train state, the
slices ``state_shardings(state, mesh, param_axes)`` gives its rank
(``reshard.py``; the rules are ``sharding/partitioning.py``'s, with their
divisibility fallback: a leaf that does not divide is replicated, and a
replicated leaf is the worker's own tensor). One update:

1. **gather**: every sharded parameter leaf is assembled whole on every
   worker from its shards (copies only, so its bits are the shards');
2. **compute**: workers ``[0, width)`` run the forward and backward of
   their microbatches on the whole leaves (through the flash kernels on the
   card), the microbatch the atomic unit as in ``step.py``;
3. **exchange**: their partial sums reach every worker of the mesh (an
   all-gather of copies: shared host slots, or NCCL with one card a worker)
   and every worker finishes the canonical tree (``span_tree_sum``) in rank
   order, so every worker holds the full summed gradient: clipping, the
   GNS's ``‖G‖²`` and the metrics are those of the unsharded run;
4. **update**: each worker applies the optimizer to its shard slices only
   (pSGD, momentum and AdaGrad-DA: one fused launch over them);
5. the whole leaves and gradients are freed: they exist only inside a step.

So the losses and the gathered parameters are bit-identical to the elastic
trainer's at any budget (``tests/test_torch_mesh_train.py``), with one
exception: LARS's and LAMB's trust ratios span a whole leaf, and under a
sharded layout each worker's per-shard sums of squares are combined in
shard order, not summed over the leaf at once (within 1e-6 relative).

Compute is data-parallel over every worker of a mesh, not only over its
``data`` axes: in the JAX package the ranks of one ``model`` group split
each matmul under GSPMD and share their rows; here a worker computes whole
microbatches, and the rules decide storage alone.

The moves between layouts (a first placement from rank 0's whole state, an
elastic width change, the whole state back on rank 0 for a checkpoint or at
the end of a run) are :func:`move_state`: every leaf assembled where it is
needed and sliced there, placement only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.distributed.staging import StagingTimes
from repro_torch.kernels.accounting import descriptors
from repro_torch.distributed.step import _combine_across, _local_total, _metrics
from repro_torch.train.state import TrainState
from repro_torch.train.step import clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_scale


@dataclass
class ShardTimes:
    """Host seconds of one sharded update's parts (the exchange's as
    :class:`StagingTimes`); the update's include the gradients' slicing."""

    gather_s: float = 0.0
    exchange: StagingTimes = field(default_factory=StagingTimes)
    update_s: float = 0.0


def tensor_leaves(state: TrainState) -> list:
    """The state's tensors, the params' first, in ``tree_leaves`` order."""
    return [x for x in tree_leaves([state.params, state.opt_state]) if isinstance(x, torch.Tensor)]


def tensor_shardings(shardings: TrainState, state: TrainState) -> list:
    """The shardings of :func:`tensor_leaves`, from ``state_shardings``'s tree."""
    pairs = zip(tree_leaves([shardings.params, shardings.opt_state]), tree_leaves([state.params, state.opt_state]),
                strict=True)
    return [s for s, t in pairs if isinstance(t, torch.Tensor)]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it) if isinstance(tree, torch.Tensor) else tree


def with_leaves(skeleton: TrainState, leaves: list, ints: Optional[TrainState] = None) -> TrainState:
    """``skeleton``'s structure with its tensors replaced by ``leaves`` (in
    :func:`tensor_leaves` order) and its host integers taken from ``ints``
    (default: the skeleton's)."""
    ints = skeleton if ints is None else ints
    it = iter(leaves)
    params = _rebuild(skeleton.params, it)
    opt_state = _rebuild(skeleton.opt_state, it)
    opt_state.update({k: v for k, v in ints.opt_state.items() if isinstance(v, int)})
    return TrainState(params, opt_state, ints.step)


def _holds(sharding, rank: int) -> bool:
    """Whether ``rank`` is the holder of its shard index of the leaf (the
    lowest rank storing that index: the one that sends it)."""
    return rank < sharding.mesh.size and sharding.holders()[sharding.shard_index(rank)] == rank


def own_shard(full: torch.Tensor, sharding, rank: int) -> torch.Tensor:
    """This rank's shard of ``full``: the tensor itself where the leaf is
    replicated, else a contiguous copy of its slice."""
    return full if sharding.replicated else full[sharding.shard_slices(rank)].contiguous()


@torch.no_grad()
def move_state(state: Optional[TrainState], skeleton: TrainState, src: list, dst: list, rank: int, xmesh,
               times: StagingTimes) -> Optional[TrainState]:
    """The state from layout ``src`` to layout ``dst`` (lists of
    :class:`~repro_torch.sharding.NamedSharding`, one per tensor leaf, on
    meshes whose ranks are prefixes of ``xmesh``'s), a collective of
    ``xmesh``'s ranks. A rank stores its ``src`` shards in ``state`` (None
    where it stores none) and returns its ``dst`` shards (None where
    ``dst``'s mesh has no such rank). Each leaf is assembled where it is
    needed, one at a time, and sliced there; the integers are rank 0's."""
    import torch.distributed as dist

    box = [None if state is None or rank != 0 else
           TrainState({}, {k: v for k, v in state.opt_state.items() if isinstance(v, int)}, state.step)]
    if xmesh.width > 1:
        dist.broadcast_object_list(box, 0, group=xmesh.group)
    mine = tensor_leaves(state) if state is not None else [None] * len(src)
    likes = tensor_leaves(skeleton)
    shards = [t if _holds(s, rank) else None for t, s in zip(mine, src)]
    del mine, state
    needs = rank < dst[0].mesh.size if dst else False
    out: List[Optional[torch.Tensor]] = [None] * len(src)
    device = torch.device(xmesh.devices[rank])
    for i, full in xmesh.exchange.assemble(shards, src, likes, xmesh, times, device, want=needs):
        shards[i] = None
        if needs:
            out[i] = own_shard(full, dst[i], rank)
        del full
    if not needs:
        return None
    return with_leaves(skeleton, out, box[0])


def gather_params(params, shardings: list, rank: int, xmesh, times: StagingTimes):
    """The params tree with every sharded leaf assembled whole (new
    tensors) and every replicated leaf this worker's own."""
    leaves = tree_leaves(params)
    idx = [i for i, s in enumerate(shardings) if not s.replicated]
    full = list(leaves)
    if idx:
        shards = [leaves[i] if _holds(shardings[i], rank) else None for i in idx]
        with descriptors():
            likes = [torch.empty(shardings[i].shape, dtype=leaves[i].dtype, device="meta") for i in idx]
        for j, leaf in xmesh.exchange.assemble(shards, [shardings[i] for i in idx], likes, xmesh, times,
                                               leaves[0].device):
            full[idx[j]] = leaf
    return _rebuild(params, iter(full))


def _leaf_sums(shardings: list, rank: int, xmesh):
    """LARS's and LAMB's per-leaf sums of squares, whole-leaf: each rank's
    per-shard sums (a (k, L) tensor) combined over the shards of each leaf
    in shard-index order (through gloo: control-sized). The same on every
    rank."""
    import torch.distributed as dist

    def combine(local: torch.Tensor) -> torch.Tensor:
        mine = local.detach().to("cpu", torch.float32)
        every = [torch.empty_like(mine) for _ in range(xmesh.width)]
        dist.all_gather(every, mine, group=xmesh.group)
        cols = []
        for i, s in enumerate(shardings):
            terms = [every[h][:, i] for h in s.holders().values()]
            total = terms[0]
            for t in terms[1:]:
                total = total + t
            cols.append(total)
        return torch.stack(cols, dim=1).to(local.device)

    return combine


def build_sharded_train_step(model, optimizer, shardings: list, *, rank: int, width: int, local_accum: int, xmesh,
                             z_loss: float = 0.0, grad_clip: float = 0.0, times: Optional[List[ShardTimes]] = None):
    """One worker's sharded step: ``step(state, batch, lr, stage) ->
    (state, metrics)``, ``state`` this worker's shards (updated in place),
    ``batch`` its chunk (local_accum, micro, ...) where ``rank < width``,
    else None (it computes nothing and receives the sum). ``shardings``
    place the parameter leaves on the mesh whose ranks are ``xmesh``'s;
    every rank of ``xmesh`` calls the step. Metrics are complete on ranks
    ``[0, width)``. ``times`` collects each call's :class:`ShardTimes`."""
    global_accum = width * local_accum
    sharded = any(not s.replicated for s in shardings)
    leaf_sums = _leaf_sums(shardings, rank, xmesh) if sharded and xmesh.width > 1 else None

    def step(state: TrainState, batch: Optional[dict], lr: float, stage: int):
        t = ShardTimes()
        t0 = time.perf_counter()
        params = gather_params(state.params, shardings, rank, xmesh, t.exchange) if sharded else state.params
        t.gather_s = time.perf_counter() - t0
        total = None
        if rank < width:
            total = _local_total(model, params, batch, local_accum, z_loss)
        del params
        if xmesh.width > 1:
            with descriptors():
                likes = [torch.empty(s.shape, dtype=torch.float32, device="meta") for s in shardings]
            total = _combine_across(total, xmesh, t.exchange, senders=width, likes=likes,
                                    device=tree_leaves(state.params)[0].device)
        grads = tree_scale(total["grads"], 1.0 / global_accum)
        total["grads"] = None
        metrics = _metrics(total, grads, global_accum)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        t1 = time.perf_counter()
        for i, s in enumerate(shardings):
            grads[i] = own_shard(grads[i], s, rank)
        kw = {"leaf_sums": leaf_sums} if leaf_sums is not None else {}
        optimizer.update(grads, state.opt_state, state.params, lr=lr, stage=stage, **kw)
        del grads
        t.update_s = time.perf_counter() - t1
        if times is not None:
            times.append(t)
        return TrainState(state.params, state.opt_state, state.step + 1), dict(metrics, grad_norm=gnorm)

    return step
