"""Train-state moves across elastic width transitions, as the JAX package's
``distributed/reshard.py``, in the port's process model: each worker of a
width-W mesh holds one replica of the state (or none, outside the mesh).

- *collapsed*: one copy of the state, rank 0's replica. Checkpoints hold
  only this form, which is what makes a checkpoint written at width W
  restorable at any width W'.
- *replicated* (exact mode) and *replica-stacked* (local SGD): a replica on
  every worker of the mesh. :func:`broadcast_state` gives rank 0's state to
  every worker of a mesh (those that join allocate theirs from a skeleton);
  :func:`collapse_state` keeps rank 0's; :func:`build_sync_step` makes the
  float leaves the replica mean (integer leaves, host integers here: step
  counters and stage ids, take replica 0's).

Placement only copies bytes (through the run's shared host slots,
``staging.py``, or NCCL, ``nccl.py``): a leaf has the same bits before and
after.

- *sharded* (exact mode with ``param_axes``; ``SEBSTrainer(mesh=...)``):
  each worker stores its shards of :func:`state_shardings` (the rules of
  ``sharding/partitioning.py``, a leaf that does not divide replicated);
  :func:`reshard_state` cuts a worker's shards from a whole state, and
  ``sharded.move_state`` moves a state between layouts across workers.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.distributed.staging import StagingTimes, from_host
from repro_torch.distributed.step import add_, span_tree_sum
from repro_torch.sharding import shard_tree
from repro_torch.train.state import TrainState, state_axes
from repro_torch.utils.tree import tree_leaves


def state_shardings(state: TrainState, mesh, param_axes=None) -> TrainState:
    """A :class:`~repro_torch.sharding.NamedSharding` for every leaf of
    ``state`` stored on ``mesh`` between steps: replicated without
    ``param_axes``, else by the rules (``param_axes`` the JAX package's
    layout, ``LanguageModel.param_axes()``)."""
    axes = state_axes(state, param_axes if param_axes is not None else _replicated_axes(state.params))
    return shard_tree(axes, state, mesh)


def _replicated_axes(params):
    if isinstance(params, dict):
        return {k: _replicated_axes(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_replicated_axes(v) for v in params]
    return (None,) * params.dim()


def reshard_state(state: TrainState, mesh=None, param_axes=None, rank: int = 0) -> TrainState:
    """Rank ``rank``'s part of ``state`` on ``mesh`` (the state itself when
    ``mesh`` is None): each leaf's shard, a copy of its slice, or the leaf
    itself where it is replicated. Placement only: the shards, concatenated
    in index order, are the leaves bit for bit."""
    if mesh is None:
        return state
    from repro_torch.distributed.sharded import own_shard

    shardings = state_shardings(state, mesh, param_axes)
    pick = lambda s, t: own_shard(t, s, rank) if isinstance(t, torch.Tensor) else t  # noqa: E731
    return TrainState(_zip_map(pick, shardings.params, state.params),
                      _zip_map(pick, shardings.opt_state, state.opt_state), state.step)


def _zip_map(fn, shardings, tree):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, shardings[k], v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, s, v) for s, v in zip(shardings, tree, strict=True)]
    return fn(shardings, tree)


def _int_leaves(state: TrainState) -> list:
    """The state's integer leaves in a fixed order: the step and the
    optimizer state's host integers."""
    return [state.step] + [v for _, v in sorted((k, v) for k, v in state.opt_state.items() if isinstance(v, int))]


def _set_int_leaves(state: TrainState, values: list) -> TrainState:
    keys = sorted(k for k, v in state.opt_state.items() if isinstance(v, int))
    for k, v in zip(keys, values[1:], strict=True):
        state.opt_state[k] = v
    return TrainState(state.params, state.opt_state, values[0])


def _replica_zero_ints(state: TrainState, group) -> TrainState:
    import torch.distributed as dist

    values = [_int_leaves(state)]
    dist.broadcast_object_list(values, 0, group=group)
    return _set_int_leaves(state, values[0])


def _allocate(skeleton: Any, device) -> Any:
    """A tree of ``skeleton``'s structure whose tensors (meta tensors there)
    are new, uninitialized ones on ``device``."""
    if isinstance(skeleton, TrainState):
        return TrainState(_allocate(skeleton.params, device), _allocate(skeleton.opt_state, device), skeleton.step)
    if isinstance(skeleton, dict):
        return {k: _allocate(v, device) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_allocate(v, device) for v in skeleton]
    if isinstance(skeleton, torch.Tensor):
        return torch.empty(skeleton.shape, dtype=skeleton.dtype, device=device)
    return skeleton


def skeleton_of(state: TrainState) -> TrainState:
    """``state`` with every tensor replaced by a meta tensor of its shape and dtype."""
    return _allocate(state, "meta")


def broadcast_state(state: Optional[TrainState], mesh, rank: int, skeleton: TrainState,
                    times: Optional[StagingTimes] = None) -> TrainState:
    """Rank 0's state onto every worker of ``mesh`` (a collective of the
    mesh's ranks). A worker that holds no replica (``state`` None) allocates
    one on its device from ``skeleton``; one that holds a replica has it
    overwritten with rank 0's bytes. Returns this worker's replica."""
    times = StagingTimes() if times is None else times
    if mesh.width == 1:
        return state
    if state is None:
        state = _allocate(skeleton, mesh.devices[rank])
    leaves = [x for x in tree_leaves([state.params, state.opt_state]) if isinstance(x, torch.Tensor)]
    mesh.exchange.broadcast(leaves, mesh, times)
    return _replica_zero_ints(state, mesh.group)


def collapse_state(state: Optional[TrainState], rank: int) -> Optional[TrainState]:
    """Replicas -> the collapsed state: rank 0 keeps its replica, every other
    worker drops its own (call after an average in local mode)."""
    return state if rank == 0 else None


def build_sync_step(mesh, rank: int, times: Optional[list] = None):
    """The local-SGD parameter average over ``mesh``: ``sync(state) ->
    state``, in place. Float leaves become the replica mean (all-gathered
    through the host bucket by bucket, summed by the canonical tree in
    replica order and divided by the width, so every replica ends with the
    same bits; a leaf is overwritten once its bytes are in this worker's
    slot); integer leaves take replica 0's. One logical all-reduce of the
    state's float payload: the only communication local-SGD mode makes
    between stage boundaries."""
    width = mesh.width

    @torch.no_grad()
    def sync(state: TrainState) -> TrainState:
        t = StagingTimes()
        leaves = [x for x in tree_leaves([state.params, state.opt_state])
                  if isinstance(x, torch.Tensor) and x.is_floating_point()]
        for i, host in mesh.exchange.all_gather(leaves, mesh, t):
            leaf = leaves[i]
            total = span_tree_sum(lambda d: from_host(host[d], leaf, t).float(), width, add_)
            leaf.copy_(total.div_(width))
        if times is not None:
            times.append(t)
        return _replica_zero_ints(state, mesh.group)

    return sync


def float_state_bytes(state: TrainState) -> int:
    """Bytes of the float leaves of ``state``: the local-SGD sync payload."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves([state.params, state.opt_state])
                   if isinstance(x, torch.Tensor) and x.is_floating_point()))
