"""Rule-based storage sharding over worker processes: ZeRO-style shards
between updates; inside a step each layer is gathered where it runs and the
gradient leaves as shard slices.

Between updates a worker stores only its shards of the train state, the
slices ``state_shardings(state, mesh, param_axes)`` gives its rank
(``reshard.py``; the rules are ``sharding/partitioning.py``'s, with their
divisibility fallback: a leaf that does not divide is replicated, and a
replicated leaf is the worker's own tensor). One update of a mesh of W
ranks, of which ranks ``[0, width)`` compute ``local_accum`` microbatches
each:

1. **gather, layer by layer**: the model gets each layer's params, and each
   other subtree (the embedding, the norms, zamba2's shared block), as this
   worker's shards (:class:`_Shards`); ``models/blocks.whole`` gathers them
   where they are used, through :class:`_Gather` (shards in, whole leaves
   out; copies only, so a leaf has its shards' bits). A layer's gather runs
   first thing in its checkpoint region: the region frees the whole leaves
   when it ends, and the backward's recomputation gathers them again. A
   tied embedding table is gathered once, for the lookup and the head, and
   zamba2's shared block once a segment, so that every leaf is gathered
   once a microbatch and its gradient reaches :class:`_Gather`'s backward
   whole, summed by autograd as it would sum a leaf's.
2. **slices out**: in that backward each leaf's f32 microbatch gradient is
   squared (its ``‖g‖²`` term), added into the leaf's local canonical tree
   (:class:`~repro_torch.distributed.step.TreeFeed`, ``span_tree_sum``
   over the rank's microbatches) and, with the last microbatch, sent as
   slices: every rank receives, from each computing rank, the slice of the
   shard index it stores (``exchange_slices``: a reduce-scatter's traffic
   as an all-to-all, nothing summed in transit) and finishes the canonical
   tree over them in rank order. Addition is elementwise, so its slice has
   the bits of the unsharded sum's, at 1/W of the bytes. The whole local
   gradient is freed once its bytes are sent. With ``local_accum > 1`` a
   computing rank keeps its local partials (at most log2(local_accum) + 1
   f32 terms a leaf, so at 2 one whole f32 gradient between microbatches):
   the slices cross once, after the last microbatch, not ``local_accum``
   times.
3. **norms with the unsharded bits**: the clip's ‖G‖ and ``grad_sq_big``
   are ``train/step._sq_norm``'s leaf-ordered sum of whole-leaf dots. Leaf
   i's summed gradient is assembled whole on one rank alone (its owner:
   its position in its subtree, mod W, so that every layer spreads alike),
   which takes its dot; the dots are all-gathered and added in leaf order.
   One whole leaf at a time exists on an owner (the largest is dbrx's
   expert tensor, 1.06 B elements).
4. **update**: each worker applies the optimizer to its shard slices only
   (pSGD, momentum and AdaGrad-DA: one fused launch over them).

Ranks past ``width`` (fewer rows than ranks) compute nothing, but serve
their shards to every gather and receive their slices, in the same order:
they run the same forward and backward on meta tensors of a computing
rank's shapes, so their gathers (of which they keep nothing) and their
exchanges follow the autograd engine's order as the computing ranks' do.
The first such pass at a chunk's shapes records its collectives, and the
later steps at those shapes replay them without the pass (a meta pass of
qwen2.5-3b's 36 layers takes ~1.7 s of host time).

So the losses and the gathered parameters are bit-identical to the
elastic trainer's at any budget (``tests/test_torch_mesh_train.py``), with
one exception: LARS's and LAMB's trust ratios span a whole leaf, and under
a sharded layout each worker's per-shard sums of squares are combined in
shard order, not summed over the leaf at once (within 1e-6 relative).

Compute is data-parallel over every worker of a mesh, not only over its
``data`` axes: in the JAX package the ranks of one ``model`` group split
each matmul under GSPMD and share their rows; here a worker computes whole
microbatches, and the rules decide storage alone.

The moves between layouts (a first placement from rank 0's whole state, an
elastic width change, the whole state back on rank 0 for a checkpoint or at
the end of a run) are :func:`move_state`: every leaf assembled where it is
needed and sliced there, placement only. :func:`gather_params` (every leaf
whole at once) serves the dry run's prefill and decode counts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.distributed.staging import StagingTimes, from_host
from repro_torch.distributed.step import (
    TreeFeed,
    _combine_across,
    _local_total,
    _metrics,
    _tree_of_partials,
    add_,
    span_tree_sum,
)
from repro_torch.kernels.accounting import descriptors
from repro_torch.train.loss import lm_loss
from repro_torch.train.state import TrainState
from repro_torch.train.step import clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_scale


@dataclass
class ShardTimes:
    """Host seconds of one sharded update's parts: the layer gathers'
    (forward and recomputation, waits included), every collective's parts
    as :class:`StagingTimes` (the gathers' too), the optimizer's."""

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
    replicated, else a copy of its slice (a copy even where the slice is
    contiguous, so that the shard does not keep the whole leaf alive)."""
    if sharding.replicated:
        return full
    return full[sharding.shard_slices(rank)].clone(memory_format=torch.contiguous_format)


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


class _Shards:
    """A subtree of the params as this worker stores it: its shards (leaf
    indices ``ids`` of the step's leaves); ``whole(keep)`` gathers the
    leaves under the top-level keys ``keep`` accepts (all by default)."""

    def __init__(self, tree, ids: list, run: "_StepRun"):
        self.tree, self.ids, self.run = tree, ids, run

    def whole(self, keep=None):
        if keep is None or not isinstance(self.tree, dict):
            tree, ids = self.tree, self.ids
        else:
            tree, it, ids = {}, iter(self.ids), []
            for k, v in self.tree.items():
                n = len(tree_leaves(v))
                mine = [next(it) for _ in range(n)]
                if keep(k):
                    tree[k] = v
                    ids += mine
        if not ids:
            return tree
        return _rebuild(tree, iter(_Gather.apply(self.run, tuple(ids), self.run.anchor)))


class _Gather(torch.autograd.Function):
    """Shards in, whole leaves out (a collective of the mesh); on the
    backward, the leaves' gradients go to :meth:`_StepRun.give`. The anchor
    (a scalar that requires grad) gives the node its place in the graph."""

    @staticmethod
    def forward(ctx, run, ids, anchor):
        ctx.run, ctx.ids = run, ids
        return tuple(run.gather(ids))

    @staticmethod
    def backward(ctx, *grads):
        ctx.run.give(ctx.ids, grads)
        return None, None, None


def _view(tree, index: dict, run: "_StepRun", groups: list, top: bool = True):
    """The params tree the model gets: each layer (an entry of a segment's
    list) and each other subtree a :class:`_Shards`; ``groups`` collects
    each one's leaf indices."""
    if isinstance(tree, list):
        return [_view(v, index, run, groups, top=False) for v in tree]
    segment = isinstance(tree, dict) and any(isinstance(v, list) for v in tree.values())
    if top or segment:
        return {k: _view(v, index, run, groups, top=False) for k, v in tree.items()}
    ids = [index[id(t)] for t in tree_leaves(tree)]
    groups.append(ids)
    return _Shards(tree, ids, run)


def _owners(groups: list, n: int, width: int) -> list:
    """Each leaf's owner for the norm: its position in its subtree, mod the
    mesh's width."""
    owners = [0] * n
    for ids in groups:
        for pos, i in enumerate(ids):
            owners[i] = pos % width
    return owners


def _dot(x: torch.Tensor) -> torch.Tensor:
    """A leaf's ‖x‖² as ``train/step._sq_norm`` takes it."""
    return torch.dot(x.reshape(-1).float(), x.reshape(-1).float())


class _StepRun:
    """One call of the sharded step on one worker: its stored shards, each
    leaf's local tree over its microbatches, the summed slices it stores."""

    def __init__(self, leaves: list, shardings: list, rank: int, width: int, local_accum: int, xmesh,
                 times: ShardTimes):
        self.leaves, self.shardings, self.rank, self.width = leaves, shardings, rank, width
        self.local_accum, self.xmesh, self.times = local_accum, xmesh, times
        self.computes = rank < width
        self.device = leaves[0].device  # where this worker's shards and slices live
        self.compute_device = self.device if self.computes else torch.device("meta")
        with descriptors():
            self.likes = [torch.empty(s.shape, dtype=t.dtype, device="meta") for s, t in zip(shardings, leaves)]
            self.grad_likes = [torch.empty(s.shape, dtype=torch.float32, device="meta") for s in shardings]
        self.holds = [_holds(s, rank) for s in shardings]
        n = len(leaves)
        self.feeds = [TreeFeed(local_accum, add_) for _ in range(n)] if self.computes else None
        self.summed: List[Optional[torch.Tensor]] = [None] * n
        self.micro, self.seen, self.dots = 0, [False] * n, [None] * n
        self.anchor = torch.zeros((), device=self.compute_device, requires_grad=True)
        self.program: Optional[list] = None  # a rank that computes nothing: its collectives, in order

    def replay(self, program: list) -> None:
        """A rank that computes nothing: the collectives its pass on meta
        tensors made (``program``), in the same order, without the pass."""
        for op, ids in program:
            if op == "gather":
                self.gather(ids)
            elif op == "give":
                self.give(ids, [None] * len(ids))
            else:
                self.end_microbatch()

    # -- the forward's (and the recomputation's) gathers
    def gather(self, ids) -> list:
        if self.program is not None:
            self.program.append(("gather", ids))
        t0 = time.perf_counter()
        out: List[Optional[torch.Tensor]] = [None] * len(ids)
        sharded = []
        for k, i in enumerate(ids):
            if not self.shardings[i].replicated:
                sharded.append(k)
            elif self.computes:
                out[k] = self.leaves[i].detach()
            else:
                out[k] = torch.empty_like(self.likes[i], device="meta")
        if sharded:
            idx = [ids[k] for k in sharded]
            shards = [self.leaves[i] if self.holds[i] else None for i in idx]
            for j, full in self.xmesh.exchange.assemble(
                    shards, [self.shardings[i] for i in idx], [self.likes[i] for i in idx], self.xmesh,
                    self.times.exchange, self.device, want=self.computes):
                out[sharded[j]] = full if full is not None else torch.empty_like(self.likes[idx[j]], device="meta")
        self.times.gather_s += time.perf_counter() - t0
        return out

    # -- the backward's gradients
    def give(self, ids, grads) -> None:
        if self.program is not None:
            self.program.append(("give", ids))
        totals = []
        for i, g in zip(ids, grads):
            if self.seen[i]:
                raise RuntimeError(f"leaf {i} was gathered twice in one microbatch")
            self.seen[i] = True
            if not self.computes:
                continue
            if g is None:  # a leaf the loss does not reach: a zero gradient, as under jax.grad
                g = torch.zeros(self.likes[i].shape, dtype=torch.float32, device=self.device)
            g = g.float()
            g = g if g.is_contiguous() else g.contiguous()
            self.dots[i] = _dot(g)
            totals.append(self.feeds[i].push(g))
        if self.micro == self.local_accum - 1:
            self._slices(list(ids), totals if self.computes else [None] * len(ids))

    def _slices(self, ids: list, totals: list) -> None:
        shardings = [self.shardings[i] for i in ids]
        for k, host in self.xmesh.exchange.exchange_slices(totals, shardings, [self.grad_likes[i] for i in ids],
                                                           self.xmesh, self.times.exchange, self.width):
            i = ids[k]
            with descriptors():
                like = torch.empty(shardings[k].shard_shape, dtype=torch.float32, device="meta")
            self.summed[i] = _tree_of_partials(host, like, self.width, self.times.exchange, self.device)

    def end_microbatch(self) -> Optional[torch.Tensor]:
        """Gives the leaves no gather reached their zero gradients; returns
        the microbatch's ‖g‖² (summed over the leaves in leaf order)."""
        unseen = [i for i, s in enumerate(self.seen) if not s]
        if unseen:
            self.give(unseen, [None] * len(unseen))
        if self.program is not None:
            self.program.append(("end", None))
        sq = sum(self.dots) if self.computes else None
        self.micro += 1
        self.seen, self.dots = [False] * len(self.seen), [None] * len(self.dots)
        return sq

    # -- the norm
    def global_sq(self, grads: list, owners: list) -> torch.Tensor:
        """``_sq_norm`` of the whole summed gradient: each leaf's dot on its
        owner (the leaf assembled there from its holders), all-gathered,
        added in leaf order."""
        ex, W = self.xmesh.exchange, self.xmesh.width
        dots = torch.zeros(len(grads), dtype=torch.float32, device=self.device)
        idx = []
        for i, s in enumerate(self.shardings):
            if not s.replicated:
                idx.append(i)
            elif owners[i] == self.rank:
                dots[i] = _dot(grads[i])
        for j, full in ex.assemble_at([grads[i] if self.holds[i] else None for i in idx],
                                      [self.shardings[i] for i in idx], [self.grad_likes[i] for i in idx],
                                      [owners[i] for i in idx], self.xmesh, self.times.exchange, self.device):
            if full is not None:
                dots[idx[j]] = _dot(full)
            del full
        with descriptors():
            like = dots.to("meta")
        every = []
        for _, host in ex.all_gather([dots], self.xmesh, self.times.exchange):
            every = [from_host(host[d], like, self.times.exchange, self.device) for d in range(W)]
        return sum(every[owners[i]][i] for i in range(len(grads)))


def build_sharded_train_step(model, optimizer, shardings: list, *, rank: int, width: int, local_accum: int, xmesh,
                             z_loss: float = 0.0, grad_clip: float = 0.0, times: Optional[List[ShardTimes]] = None):
    """One worker's sharded step: ``step(state, batch, lr, stage) ->
    (state, metrics)``, ``state`` this worker's shards (updated in place),
    ``batch`` its chunk (local_accum, micro, ...) where ``rank < width``,
    else a chunk of meta tensors of a computing rank's shapes (it computes
    nothing, see the module's docstring). ``shardings`` place the parameter
    leaves on the mesh whose ranks are ``xmesh``'s; every rank of ``xmesh``
    calls the step. Metrics are complete on every rank. ``times`` collects
    each call's :class:`ShardTimes`."""
    global_accum = width * local_accum
    sharded = any(not s.replicated for s in shardings)
    leaf_sums = _leaf_sums(shardings, rank, xmesh) if sharded and xmesh.width > 1 else None

    programs: dict = {}  # a rank that computes nothing: chunk shapes -> the collectives of its meta pass

    def scalars(a: dict, b: dict) -> dict:
        return {k: a[k] + b[k] for k in a}

    def step(state: TrainState, batch: dict, lr: float, stage: int):
        t = ShardTimes()
        leaves = tree_leaves(state.params)
        if xmesh.width == 1:  # one worker: its state is whole
            total = _local_total(model, state.params, batch, local_accum, z_loss)
            grads = tree_scale(total["grads"], 1.0 / global_accum)
            total["grads"] = None
            metrics = _metrics(total, grads, global_accum)
            sq_big = None
        else:
            run = _StepRun(leaves, shardings, rank, width, local_accum, xmesh, t)
            groups: list = []
            view = _view(state.params, {id(x): i for i, x in enumerate(leaves)}, run, groups)
            owners = _owners(groups, len(leaves), xmesh.width)
            terms = []
            key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
            if not run.computes and key in programs:
                run.replay(programs[key])
            else:
                if not run.computes:
                    run.program = programs[key] = []
                for j in range(local_accum):
                    loss, m = lm_loss(model, view, {k: v[j] for k, v in batch.items()}, z_loss=z_loss)
                    torch.autograd.backward(loss, inputs=[run.anchor])
                    del loss
                    sq = run.end_microbatch()
                    if run.computes:
                        terms.append({"loss": m["loss"].detach(), "aux": m["aux"].detach(), "sq": sq})
                run.program = None
            total = dict(span_tree_sum(lambda j: terms[j], local_accum, scalars), grads=[]) if run.computes else None
            total = _combine_across(total, xmesh, t.exchange, senders=width, likes=[],
                                    device=run.device)
            grads = tree_scale(run.summed, 1.0 / global_accum)
            run.summed = None
            sq_big = run.global_sq(grads, owners)
            metrics = _metrics(total, None, global_accum, sq_big=sq_big)
        grads, gnorm = clip_by_global_norm(grads, grad_clip, sq_norm=sq_big)
        t1 = time.perf_counter()
        kw = {"leaf_sums": leaf_sums} if leaf_sums is not None else {}
        optimizer.update(grads, state.opt_state, state.params, lr=lr, stage=stage, **kw)
        del grads
        t.update_s = time.perf_counter() - t1
        if times is not None:
            times.append(t)
        return TrainState(state.params, state.opt_state, state.step + 1), dict(metrics, grad_norm=gnorm)

    return step

