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

**Experts over the ``model`` groups.** Where the rules split an MoE
layer's experts over a ``model`` axis of M > 1 ranks (E % M == 0), the step
computes them as the JAX package does (it constrains the dispatch, the
capacity buffers ``xe`` and the hidden ``h`` to ``experts``): given the
rank's axis groups (``launch/mesh.make_axis_groups``), a layer's expert
tensors are gathered over the rank's expert group only (the ranks storing
the same E/M experts), whole in their other dimensions; the layer routes
and dispatches the rank's own tokens, sends chunk j of its capacity
buffers to ``model`` rank j (an all-to-all whose backward is the reverse
exchange, :class:`_ToExperts`), runs its experts on every token its group
sent (:class:`_LocalExperts`), returns the outputs (:class:`_FromExperts`)
and combines them locally. A rank's expert gradient then covers its
group's tokens: it is summed over the expert group by the canonical tree
in position order and lands on the ranks storing each slice. Each
sender's share of an expert's gradient is squared where the expert runs,
and the group's tables are all-gathered, so ``grad_sq_small`` keeps its
meaning. A rank without rows whose ``model`` group has some runs the pass
(on meta tensors, its experts' work real), so that it joins every
all-to-all; a rank whose group has none replays.

Only the expert path gives up bit-identity (the expert gradients' sums
change order; ``tests/test_torch_expert_parallel.py`` holds it to the
unsharded run within 1e-6). Everywhere else the losses and the gathered
parameters are bit-identical to the elastic trainer's at any budget
(``tests/test_torch_mesh_train.py``), with one exception: LARS's and
LAMB's trust ratios span a whole leaf, and under a sharded layout each
worker's per-shard sums of squares are combined in shard order, not
summed over the leaf at once (within 1e-6 relative). Attention, the dense
MLPs and the routers stay data-parallel over every worker of the mesh:
in the JAX package the ranks of one ``model`` group split those matmuls
under GSPMD and share their rows; here a worker computes whole
microbatches.

:func:`sharded_forward` is prefill or decode on a mesh, the params viewed
as the step views them: each layer gathered where it runs, the experts
over the ``model`` groups (the dry run's serving counts run it). The moves
between layouts (a first placement from rank 0's whole state, an elastic
width change, the whole state back on rank 0 for a checkpoint or at the
end of a run) are :func:`move_state`: every leaf assembled where it is
needed and sliced there, placement only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn.functional as F

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
from repro_torch.models.layers import moe
from repro_torch.sharding import NamedSharding
from repro_torch.train.loss import lm_loss
from repro_torch.train.state import TrainState
from repro_torch.train.step import clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_scale


@dataclass
class ShardTimes:
    """Host seconds of one sharded update's parts: the layer gathers'
    (forward and recomputation, waits included), every collective's parts
    as :class:`StagingTimes` (the gathers' too), the MoE experts'
    all-to-alls (their share of those, copies included), the optimizer's."""

    gather_s: float = 0.0
    exchange: StagingTimes = field(default_factory=StagingTimes)
    update_s: float = 0.0
    experts_s: float = 0.0


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
               times: StagingTimes, free_source: bool = False) -> Optional[TrainState]:
    """The state from layout ``src`` to layout ``dst`` (lists of
    :class:`~repro_torch.sharding.NamedSharding`, one per tensor leaf, on
    meshes whose ranks are prefixes of ``xmesh``'s), a collective of
    ``xmesh``'s ranks. A rank stores its ``src`` shards in ``state`` (None
    where it stores none) and returns its ``dst`` shards (None where
    ``dst``'s mesh has no such rank). Each leaf is assembled where it is
    needed, one at a time, and sliced there; the integers are rank 0's.
    ``free_source`` frees each of this rank's ``state`` tensors once its
    bytes are sent (a first placement from rank 0's own whole copy: the
    whole state and the shards are then never all on the card at once)."""
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
        if free_source and shards[i] is not None:
            shards[i].untyped_storage().resize_(0)
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
        # an MoE layer whose experts split over ``model``: its expert leaves' indices by key
        self.experts = run.expert_ids(tree, ids)

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
        out = _rebuild(tree, iter(_Gather.apply(self.run, tuple(ids), self.run.anchor)))
        if self.experts and "moe" in out:
            out["moe"] = dict(out["moe"], group=_ExpertGroup(self.run, self.experts))
        return out


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


def _splits_experts(sharding) -> bool:
    """Whether a leaf's first dimension (an MoE layer's ``experts``) is split
    over a ``model`` axis of more than one rank: the rules map ``experts``
    to ``model`` where the count divides it."""
    return sharding.mesh.shape.get("model", 1) > 1 and sharding.spec[0] == "model"


def _expert_sharding(sharding, sub) -> "NamedSharding":
    """A split expert leaf's chunk (the rank's E/M experts) on its expert
    group's sub-grid ``sub``: the leaf's other dimensions placed as before."""
    m = sharding.mesh.shape["model"]
    return NamedSharding(sub, (None,) + tuple(sharding.spec[1:]), (sharding.shape[0] // m,) + tuple(sharding.shape[1:]))


class _ExpertGroup:
    """An MoE layer's experts computed over the rank's ``model`` group (the
    ``"group"`` entry of its params, see ``models/layers/moe.py``). The
    group's first ``senders`` ranks compute rows; every rank of it holds
    E/M experts and runs them on what the senders send."""

    def __init__(self, run: "_StepRun", ids: dict):
        self.run, self.ids = run, ids  # ids: expert key -> leaf index

    def products(self, xe: torch.Tensor, params) -> torch.Tensor:
        if self.run.model_senders == 0:  # no rank of the group has rows: nothing to send or compute
            return torch.empty_like(xe, device="meta")
        xr = _ToExperts.apply(self, xe)
        yr = _LocalExperts.apply(self, xr, *(params[k] for k in moe.EXPERT_KEYS))
        return _FromExperts.apply(self, yr)

    def dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, n, E, C, d), this rank's buffers (meta where it has no
        rows): chunk q of the experts to position q of the group; returns
        what each sender sent this rank, (S, B, n, E/M, C, d)."""
        run, g = self.run, self.run.axis.model
        t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
        m, senders = g.width, run.model_senders
        k = x.shape[2] // m
        sends = [x[:, :, q * k:(q + 1) * k].contiguous() for q in range(m)] if run.computes else [None] * m
        with descriptors():
            like = torch.empty(x.shape[:2] + (k,) + x.shape[3:], dtype=x.dtype, device="meta")
        got = g.exchange.to_all(sends, {p: like for p in range(senders)}, g, run.times.exchange, run.device)
        out = torch.stack([got[p] for p in range(senders)])
        run.times.experts_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
        return out

    def combine(self, y: torch.Tensor) -> torch.Tensor:
        """The reverse of :meth:`dispatch`: y (S, B, n, E/M, C, d), block p
        back to sender p; returns this rank's (B, n, E, C, d) (meta where it
        has no rows)."""
        run, g = self.run, self.run.axis.model
        t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
        m = g.width
        shape = y.shape[1:3] + (m * y.shape[3],) + y.shape[4:]
        sends = [y[p] for p in range(y.shape[0])] + [None] * (m - y.shape[0])
        with descriptors():
            like = torch.empty(y.shape[1:], dtype=y.dtype, device="meta")
        got = g.exchange.to_all(sends, {q: like for q in range(m)} if run.computes else {}, g,
                                run.times.exchange, run.device)
        out = (torch.cat([got[q] for q in range(m)], dim=2) if run.computes
               else torch.empty(shape, dtype=y.dtype, device="meta"))
        run.times.experts_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
        return out


class _ToExperts(torch.autograd.Function):
    """The all-to-all of an MoE layer's buffers to the ranks holding their
    experts; its backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, group, xe):
        ctx.group = group
        return group.dispatch(xe)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.group.combine(grad)


class _FromExperts(torch.autograd.Function):
    """The all-to-all of the experts' outputs back to the ranks whose tokens
    they are; its backward is the forward exchange."""

    @staticmethod
    def forward(ctx, group, yr):
        ctx.group = group
        return group.combine(yr)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.group.dispatch(grad)


class _LocalExperts(torch.autograd.Function):
    """The rank's experts on what its group sent, xr (S, B, n, E/M, C, d):
    ``moe.expert_products``. The backward takes each expert tensor's
    gradient sender by sender, adds them in f32 in sender order and reports
    each sender's ‖·‖² to the run: a sender's microbatch ‖g‖²
    (``grad_sq_small``) is its own rows' share of every expert's gradient."""

    @staticmethod
    def forward(ctx, group, xr, w_gate, w_up, w_down):
        ctx.group = group
        ctx.save_for_backward(xr, w_gate, w_up, w_down)
        return moe.expert_products(xr.flatten(0, 1), w_gate, w_up, w_down).reshape(xr.shape)

    @staticmethod
    def backward(ctx, dy):
        xr, w_gate, w_up, w_down = ctx.saved_tensors
        c = xr.dtype
        wg, wu, wd = w_gate.to(c), w_up.to(c), w_down.to(c)
        gate = torch.einsum("sbnecd,edf->sbnecf", xr, wg)
        up = torch.einsum("sbnecd,edf->sbnecf", xr, wu)
        act = F.silu(gate)
        h = act * up
        dh = torch.einsum("sbnecd,efd->sbnecf", dy, wd)
        dup = dh * act
        dgate = torch.ops.aten.silu_backward(dh * up, gate)
        del dh, act
        dx = torch.einsum("sbnecf,edf->sbnecd", dgate, wg) + torch.einsum("sbnecf,edf->sbnecd", dup, wu)
        del wg, wu, wd
        sums = {k: None for k in moe.EXPERT_KEYS}
        sq = {k: [] for k in moe.EXPERT_KEYS}
        for s in range(xr.shape[0]):
            for k, g in (("w_gate", torch.einsum("bnecd,bnecf->edf", xr[s], dgate[s])),
                         ("w_up", torch.einsum("bnecd,bnecf->edf", xr[s], dup[s])),
                         ("w_down", torch.einsum("bnecf,bnecd->efd", h[s], dy[s]))):
                g = g.float()
                sq[k].append(_dot(g))
                sums[k] = g if sums[k] is None else sums[k].add_(g)
        run = ctx.group.run
        for k in moe.EXPERT_KEYS:
            run.expert_sq[ctx.group.ids[k]] = torch.stack(sq[k])
        return (None, dx) + tuple(sums[k].to(w.dtype) for k, w in zip(moe.EXPERT_KEYS, (w_gate, w_up, w_down)))


class _StepRun:
    """One call of the sharded step on one worker: its stored shards, each
    leaf's local tree over its microbatches, the summed slices it stores.
    With ``axis`` (the rank's :class:`~repro_torch.launch.mesh.AxisGroups`),
    an MoE layer's experts split over ``model`` are gathered over the
    rank's expert group and computed over its ``model`` group."""

    def __init__(self, leaves: list, shardings: list, rank: int, width: int, local_accum: int, xmesh,
                 times: ShardTimes, axis=None):
        self.leaves, self.shardings, self.rank, self.width = leaves, shardings, rank, width
        self.local_accum, self.xmesh, self.times, self.axis = local_accum, xmesh, times, axis
        self.computes = rank < width
        self.device = leaves[0].device  # where this worker's shards and slices live
        self.compute_device = self.device if self.computes else torch.device("meta")
        with descriptors():
            self.likes = [torch.empty(s.shape, dtype=t.dtype, device="meta") for s, t in zip(shardings, leaves)]
            self.grad_likes = [torch.empty(s.shape, dtype=torch.float32, device="meta") for s in shardings]
        self.holds = [_holds(s, rank) for s in shardings]
        n = len(leaves)
        # expert parallelism: the split expert leaves (filled in by the view), their chunks' shardings on the
        # expert group, how many ranks of the model group and positions of the expert group compute rows
        self.ep: dict = {}
        self.expert_sq: dict = {}  # leaf index -> each sender's ‖g‖² of this microbatch (``_LocalExperts``)
        if axis is not None:
            m = axis.model.width
            first = axis.model.ranks[0]
            self.model_senders = max(0, min(m, width - first))
            self.expert_senders = min(axis.experts.width, -(-width // m))
            self.sub = axis.mesh.submesh(rank, axis.expert_axes)
        else:
            self.model_senders = 0
        self.feeds = [TreeFeed(local_accum, add_) for _ in range(n)]
        self.summed: List[Optional[torch.Tensor]] = [None] * n
        self.micro, self.seen, self.dots = 0, [False] * n, [None] * n
        self.anchor = torch.zeros((), device=self.compute_device, requires_grad=True)
        self.program: Optional[list] = None  # a rank that computes nothing: its collectives, in order
        self.gathered: Optional[set] = None  # the leaves gathered (the dry run's serving count reads it)

    def expert_ids(self, tree, ids: list) -> dict:
        """For a layer's params (``tree``, leaf indices ``ids``) with an MoE
        whose experts split over ``model``: expert key -> leaf index
        (registered as split); else {}."""
        if self.axis is None or not isinstance(tree, dict) or "moe" not in tree:
            return {}
        it, found = iter(ids), {}
        for k, v in tree.items():
            mine = [next(it) for _ in tree_leaves(v)]
            if k == "moe":
                found = {name: i for name, i in zip(v, mine) if name in moe.EXPERT_KEYS}
        if not found or not all(_splits_experts(self.shardings[i]) for i in found.values()):
            return {}
        pos = self.axis.experts.index(self.rank)
        for i in found.values():
            sh = _expert_sharding(self.shardings[i], self.sub)
            with descriptors():
                like = torch.empty(sh.shape, dtype=self.leaves[i].dtype, device="meta")
                grad_like = torch.empty(sh.shape, dtype=torch.float32, device="meta")
            self.ep[i] = (sh, _holds(sh, pos), like, grad_like)
        return found

    @property
    def group_computes(self) -> bool:
        return self.model_senders > 0

    @property
    def passes(self) -> bool:
        """Whether this rank runs the pass: it computes rows, or its
        ``model`` group does and it holds experts that the group's tokens
        reach."""
        return self.computes or (bool(self.ep) and self.group_computes)

    def _sends(self, i: int) -> bool:
        return self.group_computes if i in self.ep else self.computes

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
        if self.gathered is not None:
            self.gathered.update(ids)
        t0 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
        out: List[Optional[torch.Tensor]] = [None] * len(ids)
        sharded, split = [], []
        for k, i in enumerate(ids):
            if i in self.ep:
                split.append(k)
            elif not self.shardings[i].replicated:
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
        if split and self.axis.experts.width == 1:  # the rank stores its experts whole: nothing to gather
            for k in split:
                i = ids[k]
                out[k] = self.leaves[i].detach() if self.group_computes else torch.empty_like(self.ep[i][2],
                                                                                              device="meta")
        elif split:  # the rank's experts, over its expert group
            idx = [ids[k] for k in split]
            g = self.axis.experts
            shards = [self.leaves[i] if self.ep[i][1] else None for i in idx]
            for j, full in g.exchange.assemble(shards, [self.ep[i][0] for i in idx], [self.ep[i][2] for i in idx],
                                               g, self.times.exchange, self.device, want=self.group_computes):
                out[split[j]] = full if full is not None else torch.empty_like(self.ep[idx[j]][2], device="meta")
        self.times.gather_s += time.perf_counter() - t0  # repro-lint: disable=R103 -- host timing only
        return out

    # -- the backward's gradients
    def give(self, ids, grads) -> None:
        if self.program is not None:
            self.program.append(("give", ids))
        totals: List[Optional[torch.Tensor]] = []
        for i, g in zip(ids, grads):
            if self.seen[i]:
                raise RuntimeError(f"leaf {i} was gathered twice in one microbatch")
            self.seen[i] = True
            if not self._sends(i):
                totals.append(None)
                continue
            if g is None:  # a leaf the loss does not reach: a zero gradient, as under jax.grad
                like = self.ep[i][3] if i in self.ep else self.likes[i]
                g = torch.zeros(like.shape, dtype=torch.float32, device=self.device)
            g = g.float()
            g = g if g.is_contiguous() else g.contiguous()
            if i not in self.ep:  # a split expert leaf's ‖g‖² comes from its senders' shares
                self.dots[i] = _dot(g)
            totals.append(self.feeds[i].push(g))
        if self.micro == self.local_accum - 1:
            self._slices(list(ids), totals)

    def _slices(self, ids: list, totals: list) -> None:
        rest = [k for k, i in enumerate(ids) if i not in self.ep]
        split = [k for k, i in enumerate(ids) if i in self.ep]
        if rest:
            self._sum_slices([ids[k] for k in rest], [totals[k] for k in rest],
                             [self.shardings[ids[k]] for k in rest], [self.grad_likes[ids[k]] for k in rest],
                             self.xmesh, self.width)
        if split:  # summed over the expert group: each position's partial covers its model group's rows
            self._sum_slices([ids[k] for k in split], [totals[k] for k in split],
                             [self.ep[ids[k]][0] for k in split], [self.ep[ids[k]][3] for k in split],
                             self.axis.experts, self.expert_senders)

    def _sum_slices(self, ids: list, totals: list, shardings: list, likes: list, mesh, senders: int) -> None:
        if mesh.width == 1:  # one rank stores the leaves whole and sends them: its total is the sum
            for i, total in zip(ids, totals):
                self.summed[i] = total
            return
        for k, host in mesh.exchange.exchange_slices(totals, shardings, likes, mesh, self.times.exchange, senders):
            i = ids[k]
            with descriptors():
                like = torch.empty(shardings[k].shard_shape, dtype=torch.float32, device="meta")
            self.summed[i] = _tree_of_partials(host, like, senders, self.times.exchange, self.device)

    def _expert_dots(self) -> None:
        """Each split expert leaf's ‖g‖² of this microbatch on each sender of
        the ``model`` group: the group's tables of every sender's share
        (one a rank, over its experts) all-gathered and added in position
        order."""
        g = self.axis.model
        order = sorted(self.ep)
        senders = self.model_senders
        zero = torch.zeros(senders, dtype=torch.float32, device=self.device)  # a leaf the loss did not reach
        table = torch.stack([self.expert_sq.get(i, zero) for i in order])
        self.expert_sq = {}
        with descriptors():
            like = table.to("meta")
        every = []
        for _, host in g.exchange.all_gather([table], g, self.times.exchange):
            every = [from_host(host[q], like, self.times.exchange, self.device) for q in range(g.width)]
        if self.computes:
            me = g.index(self.rank)
            col = every[0][:, me]
            for q in range(1, g.width):
                col = col + every[q][:, me]
            for n, i in enumerate(order):
                self.dots[i] = col[n]

    def end_microbatch(self) -> Optional[torch.Tensor]:
        """Gives the leaves no gather reached their zero gradients; returns
        the microbatch's ‖g‖² (summed over the leaves in leaf order)."""
        unseen = [i for i, s in enumerate(self.seen) if not s]
        if unseen:
            self.give(unseen, [None] * len(unseen))
        if self.ep and self.group_computes:
            self._expert_dots()
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


@torch.no_grad()
def sharded_forward(model, params, shardings: list, *, rank: int, width: int, xmesh, kind: str, batch: dict,
                    cache, cache_index=None, memory=None, axis=None, times: Optional[ShardTimes] = None,
                    gathered: Optional[set] = None):
    """One worker's prefill (``kind`` "prefill") or decode step ("decode")
    on a mesh: ``params`` this worker's shards (``shardings`` place the
    leaves on the mesh whose ranks are ``xmesh``'s; every rank calls it),
    viewed as the train step views them, so that each layer is gathered
    where it runs and an MoE layer's experts split over ``model`` are
    computed over the rank's ``model`` group (``axis``). ``batch`` and
    ``cache`` are this rank's rows where ``rank < width``, else meta
    tensors of a computing rank's shapes: such a rank serves its shards to
    every gather and, where its ``model`` group has rows, runs its experts
    on them. Returns ``model.prefill``'s or ``model.decode_step``'s
    (logits, cache), meta where the rank has no rows; ``gathered`` collects
    the indices of the leaves the step read."""
    leaves = tree_leaves(params)
    run = _StepRun(leaves, shardings, rank, width, 1, xmesh, ShardTimes() if times is None else times, axis)
    run.gathered = gathered
    view = _view(params, {id(x): i for i, x in enumerate(leaves)}, run, [])
    if kind == "prefill":
        return model.prefill(view, batch, cache, memory=memory)
    return model.decode_step(view, batch["tokens"], cache, cache_index, memory=memory)


def build_sharded_train_step(model, optimizer, shardings: list, *, rank: int, width: int, local_accum: int, xmesh,
                             z_loss: float = 0.0, grad_clip: float = 0.0, times: Optional[List[ShardTimes]] = None,
                             axis=None):
    """One worker's sharded step: ``step(state, batch, lr, stage) ->
    (state, metrics)``, ``state`` this worker's shards (updated in place),
    ``batch`` its chunk (local_accum, micro, ...) where ``rank < width``,
    else a chunk of meta tensors of a computing rank's shapes (it computes
    nothing, see the module's docstring). ``shardings`` place the parameter
    leaves on the mesh whose ranks are ``xmesh``'s; every rank of ``xmesh``
    calls the step. Metrics are complete on every rank. ``times`` collects
    each call's :class:`ShardTimes`. ``axis`` (the rank's
    :class:`~repro_torch.launch.mesh.AxisGroups` on the shardings' mesh)
    computes an MoE layer's experts over the ``model`` group where the
    rules split them over ``model``; without it every rank runs every
    expert."""
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
            run = _StepRun(leaves, shardings, rank, width, local_accum, xmesh, t, axis)
            groups: list = []
            view = _view(state.params, {id(x): i for i, x in enumerate(leaves)}, run, groups)
            owners = _owners(groups, len(leaves), xmesh.width)
            terms = []
            key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
            if not run.passes and key in programs:
                run.replay(programs[key])
            else:
                if not run.passes:
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
        t1 = time.perf_counter()  # repro-lint: disable=R103 -- host timing only
        kw = {"leaf_sums": leaf_sums} if leaf_sums is not None else {}
        optimizer.update(grads, state.opt_state, state.params, lr=lr, stage=stage, **kw)
        del grads
        t.update_s = time.perf_counter() - t1  # repro-lint: disable=R103 -- host timing only
        if times is not None:
            times.append(t)
        return TrainState(state.params, state.opt_state, state.step + 1), dict(metrics, grad_norm=gnorm)

    return step

