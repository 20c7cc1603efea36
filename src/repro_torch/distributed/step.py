"""Elastic data-parallel train steps, as the JAX package's
``distributed/step.py``, for one worker process of a width-W mesh.

Exact-sync mode must give *bit-identical results at every width*. Two
ingredients deliver it:

1. The microbatch is the atomic unit of compute. Every width runs the same
   (microbatch, seq) forward and backward, so each microbatch's gradient
   has the same bits wherever it ran; only the assignment of microbatches
   to workers changes.
2. The sum over microbatches is a canonical fixed-shape pairwise tree
   (:func:`span_tree_sum`), not a serial sum or a backend's all-reduce.
   Each worker tree-sums its local chunk, the W partial sums are
   all-gathered, and every worker finishes the SAME global tree over them
   in replica order: the order of the additions depends on the global
   accumulation count only.

The port's single-process step (``train/step.py``) sums serially and stays
as it is; these are separate builders.

Each microbatch's term is its f32 gradient (taken leaf by leaf in a
post-accumulate hook, as ``train/step.py`` takes it), its loss, its aux and
its ‖g‖². The local tree adds the right subtree into the left one in place
and evaluates left first, so at most log2(local_accum) + 1 gradient-sized
terms are alive at once. The all-gather goes through the host: each partial
is copied into this worker's shared host slot, and every worker copies the
W partials back from the slots, bucket by bucket (``staging.py``); the
combine is elementwise, so the bits do not depend on where it ran.

Local-SGD mode has no per-update collective: each worker updates its own
replica from its own chunk's mean gradient, and parameter averages are a
separate step (``reshard.build_sync_step``) on the scheduler's cadence.

Bits must not depend on the process a microbatch ran in: every worker runs
with the caller's thread count and TF32 and matmul-precision settings (the
trainer passes them), and on the card the path's kernels use no atomics (a
chip check runs one microbatch twice and compares the gradient bits).
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch

from repro_torch.distributed.staging import StagingTimes, from_host
from repro_torch.kernels.accounting import descriptors, kernel_region
from repro_torch.train.loss import lm_loss
from repro_torch.train.state import TrainState
from repro_torch.train.step import _sq_norm, clip_by_global_norm
from repro_torch.utils.tree import tree_add, tree_leaves, tree_scale


def span_tree_sum(get: Callable[[int], object], n: int, add: Callable = tree_add):
    """Canonical pairwise reduction of ``n`` terms: split at n//2, for every n.

    The tree's shape depends only on ``n``, never on how the terms are spread
    over workers, so for any power-of-two W dividing n, W workers that
    tree-sum their n/W-term chunks and then tree-combine the W partials in
    replica order reproduce the width-1 sum bit for bit: the top log2(W)
    splits of the global tree land on the chunk boundaries. ``get(i)`` is
    called in increasing ``i``, the left subtree first."""
    assert n >= 1
    if n == 1:
        return get(0)
    mid = n // 2
    left = span_tree_sum(get, mid, add)
    right = span_tree_sum(lambda i: get(mid + i), n - mid, add)
    return add(left, right)


@functools.lru_cache(maxsize=None)
def _tree_program(n: int, lo: int = 0) -> tuple:
    """:func:`span_tree_sum`'s evaluation over terms ``[lo, lo + n)`` as a
    program: an int fetches that term, ``None`` adds the top term into the
    one below it."""
    if n == 1:
        return (lo,)
    mid = n // 2
    return _tree_program(mid, lo) + _tree_program(n - mid, lo + mid) + (None,)


class TreeFeed:
    """:func:`span_tree_sum` over ``n`` terms that arrive one at a time, in
    index order: the same additions in the same order (``add(left,
    right)``), at most log2(n) + 1 terms alive. :meth:`push` returns the
    sum with the last term, else None."""

    def __init__(self, n: int, add: Callable):
        self.ops, self.pc, self.stack, self.add = _tree_program(n), 0, [], add

    def push(self, term):
        assert self.ops[self.pc] is not None, "the tree is complete"
        self.stack.append(term)
        self.pc += 1
        while self.pc < len(self.ops) and self.ops[self.pc] is None:
            right = self.stack.pop()
            self.stack.append(self.add(self.stack.pop(), right))
            self.pc += 1
        return self.stack.pop() if self.pc == len(self.ops) else None


def add_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` into ``a`` (a fresh copy): the bits of ``a + b``, one buffer fewer."""
    return a.add_(b)


def _add_into(a: dict, b: dict) -> dict:
    """``a + b`` for microbatch terms, the gradients added into ``a``'s."""
    for x, y in zip(a["grads"], b["grads"]):
        x.add_(y)
    return {"grads": a["grads"], "loss": a["loss"] + b["loss"], "aux": a["aux"] + b["aux"],
            "sq": a["sq"] + b["sq"]}


def _local_total(model, params, batch: dict, local_accum: int, z_loss: float) -> dict:
    """The canonical tree's sum over the ``local_accum`` microbatches of
    ``batch`` (leaves (local_accum, micro, ...)) of each microbatch's term."""
    leaves = tree_leaves(params)
    index = {id(w): i for i, w in enumerate(leaves)}
    grads: List[Optional[torch.Tensor]] = []

    def take(w):
        g, w.grad = w.grad, None
        grads[index[id(w)]] = g.float()

    def term(i: int) -> dict:
        grads[:] = [None] * len(leaves)
        total, m = lm_loss(model, params, {k: v[i] for k, v in batch.items()}, z_loss=z_loss)
        torch.autograd.backward(total, inputs=leaves)
        del total
        out = [g if g is not None else torch.zeros_like(w, dtype=torch.float32)  # not reached by the loss
               for g, w in zip(grads, leaves)]
        grads[:] = []
        return {"grads": out, "loss": m["loss"].detach(), "aux": m["aux"].detach(), "sq": _sq_norm(out)}

    for w in leaves:
        w.requires_grad_(True)
        w.grad = None
    hooks = [w.register_post_accumulate_grad_hook(take) for w in leaves]
    try:
        return span_tree_sum(term, local_accum, _add_into)
    finally:
        for h in hooks:
            h.remove()


def _combine_across(total: Optional[dict], mesh, times: StagingTimes, senders: Optional[int] = None,
                    likes: Optional[list] = None, device=None) -> dict:
    """The partial sums of ranks ``[0, senders)`` (default: every rank of
    the mesh), all-gathered (through the host, or NCCL) and combined by the
    canonical tree in replica order: the same result on every worker of the
    mesh. Each local leaf goes as soon as its bytes are sent. A rank that
    does not send passes ``total`` None, and the gradients' ``likes`` (meta
    tensors) and its ``device``."""
    senders = mesh.width if senders is None else senders
    with descriptors():
        meta_scalars = torch.empty(3, dtype=torch.float32, device="meta")
    if total is None:
        parts = list(likes) + [meta_scalars]
    else:
        scalars = torch.stack([total["loss"].float(), total["aux"].float(), total["sq"].float()])
        parts = total["grads"] + [scalars]
        device = scalars.device
        total["grads"] = None
    with descriptors():
        metas = [t.to("meta") for t in parts]
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for i, host in mesh.exchange.all_gather(parts, mesh, times, consume=True, senders=senders):
        out[i] = _tree_of_partials(host, metas[i], senders, times, device)
    s = out.pop()
    return {"grads": out, "loss": s[0], "aux": s[1], "sq": s[2]}


def _tree_of_partials(host: list, like: torch.Tensor, senders: int, times: StagingTimes, device) -> torch.Tensor:
    """One leaf's partials from the host (``host[d]``: sender d's bytes)
    combined by the canonical tree. On meta tensors (the dry run) the same
    work is reported whole and nothing is computed: each partial copied back
    (its bytes read and written), each add reading two terms and writing
    one, and the tree's most live terms allocated at once, which is the
    op-by-op run's count and high-water mark."""
    if torch.device(device).type != "meta":
        return span_tree_sum(lambda d: from_host(host[d], like, times, device), senders, add_)
    n = like.numel() * like.element_size()
    times.received_bytes += senders * n
    with kernel_region("exchange_tree_sum", 0.0, float(2 * senders * n + 3 * (senders - 1) * n)):
        live = [torch.empty(like.shape, dtype=like.dtype, device=device) for _ in range(_tree_live_terms(senders))]
    return live[0]


def _tree_live_terms(n: int) -> int:
    """The most terms :func:`span_tree_sum` holds at once over ``n`` (each
    fetched term new, the right subtree added into the left)."""
    if n == 1:
        return 1
    mid = n // 2
    return max(_tree_live_terms(mid), 1 + _tree_live_terms(n - mid))


def _apply(optimizer, state: TrainState, grads, lr, stage, grad_clip):
    grads, gnorm = clip_by_global_norm(grads, grad_clip)
    optimizer.update(grads, state.opt_state, state.params, lr=lr, stage=stage)
    return TrainState(state.params, state.opt_state, state.step + 1), gnorm


def _metrics(total: dict, grads, n: int, sq_big=None) -> dict:
    """The step's metrics; ``sq_big`` is ‖G‖² where the caller has it (else ``_sq_norm(grads)``)."""
    return {"loss": total["loss"] / n, "aux": total["aux"] / n, "grad_sq_small": total["sq"] / n,
            "grad_sq_big": _sq_norm(grads) if sq_big is None else sq_big}


def build_elastic_train_step(model, optimizer, mesh, *, width: int, local_accum: int, z_loss: float = 0.0,
                             grad_clip: float = 0.0, times: Optional[List[StagingTimes]] = None):
    """Exact-sync step of one worker: ``step(state, batch, lr, stage) ->
    (state, metrics)``, the state updated in place.

    ``state`` is this worker's replica; ``batch`` leaves are its chunk,
    (local_accum, micro, ...). The only collective is one all-gather of the
    partial sums per update (leaf by leaf, through the host). Every worker
    of the mesh ends with the same gradients and applies the same update,
    bit for bit, whatever the width. ``times`` collects each call's
    :class:`StagingTimes` when given (width > 1)."""
    if mesh.width != width:
        raise ValueError(f"mesh of width {mesh.width} for a step of width {width}")
    global_accum = width * local_accum

    def step(state: TrainState, batch: dict, lr: float, stage: int):
        total = _local_total(model, state.params, batch, local_accum, z_loss)
        if width > 1:
            # THE sync point: partial sums cross workers once per update, by an
            # all-gather and the explicit tree, not an all-reduce in gloo's order
            t = StagingTimes()
            total = _combine_across(total, mesh, t)
            if times is not None:
                times.append(t)
        grads = tree_scale(total["grads"], 1.0 / global_accum)
        total["grads"] = None
        metrics = _metrics(total, grads, global_accum)
        state, gnorm = _apply(optimizer, state, grads, lr, stage, grad_clip)
        return state, dict(metrics, grad_norm=gnorm)

    return step


def build_local_train_step(model, optimizer, mesh, *, width: int, local_accum: int, z_loss: float = 0.0,
                           grad_clip: float = 0.0):
    """Local-SGD step of one worker: its replica takes an update from its
    own chunk's mean gradient, with no collective. Metrics are this
    replica's; averaging is ``reshard.build_sync_step``'s."""
    assert width > 1, "width-1 local SGD is exact sync; use the elastic step"

    def step(state: TrainState, batch: dict, lr: float, stage: int):
        total = _local_total(model, state.params, batch, local_accum, z_loss)
        grads = tree_scale(total["grads"], 1.0 / local_accum)
        total["grads"] = None
        metrics = _metrics(total, grads, local_accum)
        state, gnorm = _apply(optimizer, state, grads, lr, stage, grad_clip)
        return state, dict(metrics, grad_norm=gnorm)

    return step
