"""Dry run: every (architecture × input shape × mesh) combination counted on
meta tensors, the port's counterpart of the JAX package's
``launch/dryrun.py`` (which lowers and compiles each with
``ShapeDtypeStruct`` stand-ins on 512 placeholder devices).

Where JAX compiles, the port runs the same step on ``meta`` tensors under a
counting dispatch mode (``roofline/counter.py``): nothing is allocated and
nothing is computed, and the step is the port's own execution, op by op.
The production meshes are ``make_production_mesh(devices=["meta"] * 256)``
and ``* 512``: JAX's (16, 16) and (2, 16, 16). Per combo, rank 0's
numbers, under JAX's keys:

- ``memory``: ``argument_bytes_per_device``, the rank's shards of the
  arguments under the sharding rules (the train state under
  ``state_shardings``, each host integer a 4-byte scalar as JAX's int32;
  the batch under ``batch_spec``; the learning rate and stage, 8 bytes;
  for prefill and decode the parameters, the cache, the batch, the cache
  index and the encoder memory, each where the step reads it, as XLA keeps
  only the arguments a step uses); ``temp_bytes_per_device``, the high-water mark
  of the storages the step creates, less the outputs it leaves;
  ``output_bytes_per_device`` and ``alias_bytes_per_device`` (outputs
  that are arguments updated in place); ``peak_bytes_per_device``
  (argument + output + temp - alias: the arguments plus the high-water
  mark); and ``activation_bytes_per_microbatch``, what one microbatch's
  forward leaves alive for its backward under the config's remat policy.
- ``cost``: ``flops`` (``torch.utils.flop_counter``'s formulas plus the
  kernels' own counts) and ``bytes_accessed`` (each op's operands; the
  kernels' own counts), with ``kernels`` giving each kernel's calls,
  operations and bytes.
- ``collectives`` (``roofline/collectives.py``): what the step's transport
  moves to the rank.

What runs. Compute is data-parallel over every rank but for an MoE
layer's experts, which the rules split over ``model`` and which run over
the rank's ``model`` group (``distributed/sharded.py``): rank 0 runs
``build_sharded_train_step`` on its rows of the global batch (ranks past
the batch's rows compute nothing and receive their slices), with a
recording transport (:class:`RecordingExchange`, over the rank's axis
groups too, :func:`recording_axes`) in place of the host slots or NCCL:
each layer's gather (``all-gather``; the experts' over the expert group),
the experts' buffers to and from their ranks, each exchange of the
gradient's slices and each leaf's assembly for the norm (``all-to-all``)
are recorded, and their results are meta tensors. A one-rank mesh runs
``train/step.py``'s step, which the trainer runs on one device. Prefill
and decode run ``sharded_forward`` on the rank's rows of the batch and
cache: each layer gathered where it runs, the experts as in training.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import INPUT_SHAPES, list_archs
from repro_torch.configs.shapes import InputShape, config_for, input_specs, shape_applicable
from repro_torch.distributed.reshard import reshard_state, state_shardings
from repro_torch.distributed.sharded import (
    _rebuild,
    build_sharded_train_step,
    own_shard,
    sharded_forward,
    tensor_leaves,
    tensor_shardings,
)
from repro_torch.distributed.staging import StagingTimes
from repro_torch.launch.mesh import AxisGroups, DataMesh, axis_groups, make_production_mesh, rank_rows
from repro_torch.models import LanguageModel
from repro_torch.optim import make_optimizer
from repro_torch.roofline.collectives import CollectiveLog
from repro_torch.roofline.counter import StepCounter
from repro_torch.sharding import NamedSharding, batch_spec, shard_tree
from repro_torch.train.loss import lm_loss
from repro_torch.train.state import TrainState, unstack_axes
from repro_torch.train.step import build_train_step
from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import tree_leaves

log = get_logger("dryrun")

SCALAR_BYTES = 4  # a host integer or the learning rate: JAX's int32 / f32 scalars


# ---------------------------------------------------------------------------
# abstract state construction (no allocation)
# ---------------------------------------------------------------------------


def abstract_params(model: LanguageModel, device="meta"):
    """The params as tensors on ``device``: empty meta ones by default, the
    seed-0 weights elsewhere (the tests' real counts)."""
    return model.abstract_init() if torch.device(device).type == "meta" else model.init(0, device=device)


def abstract_train_state(model: LanguageModel, optimizer, device="meta"):
    """(the whole train state on ``device``, the params' logical axes)."""
    params = abstract_params(model, device)
    return TrainState(params, optimizer.init(params), 0), model.param_axes()


def abstract_cache(model: LanguageModel, batch: int, cache_len: int, device="meta"):
    return model.init_cache(batch, cache_len, dtype=torch.bfloat16, device=device)


class RecordingExchange:
    """The sharded step's transport for rank ``rank`` counted alone: each
    collective is recorded in ``log`` (what the rank receives) and its
    results are new tensors of the right shapes on the rank's device (meta
    in the dry run), as the host slots' would be. ``slot_bytes`` is the
    largest part a collective moves: the received parts are views of one
    slot made before the count, as the host slots are. The layer gathers
    are all-gathers; the gradient's slices and the norm's assembly of each
    leaf on its owner are all-to-alls."""

    def __init__(self, device, slot_bytes: int, rank: int = 0):
        self.log = CollectiveLog()
        self.rank = rank
        on_meta = torch.device(device).type == "meta"
        self.slot = torch.zeros(slot_bytes, dtype=torch.uint8, device="meta" if on_meta else "cpu")

    def assemble(self, shards, shardings, likes, mesh, times: StagingTimes, device, want: bool = True):
        for i, like in enumerate(likes):
            if not want:
                yield i, None
                continue
            nbytes = like.numel() * like.element_size()
            self.log.record("all-gather", nbytes)
            times.received_bytes += nbytes
            yield i, torch.empty(like.shape, dtype=like.dtype, device=device)

    def assemble_at(self, shards, shardings, likes, owners, mesh, times: StagingTimes, device):
        for i, like in enumerate(likes):
            if owners[i] != self.rank:
                yield i, None
                continue
            nbytes = like.numel() * like.element_size()
            self.log.record("all-to-all", nbytes)
            times.received_bytes += nbytes
            yield i, torch.empty(like.shape, dtype=like.dtype, device=device)

    def exchange_slices(self, tensors, shardings, likes, mesh, times: StagingTimes, senders: int):
        for i, (sharding, like) in enumerate(zip(shardings, likes)):
            nbytes = like.numel() * like.element_size() // sharding.num_shards
            self.log.record("all-to-all", senders * nbytes)
            tensors[i] = None
            yield i, [self.slot[:nbytes]] * senders

    def to_all(self, sends, recv_likes, mesh, times: StagingTimes, device):
        nbytes = sum(like.numel() * like.element_size() for like in recv_likes.values())
        self.log.record("all-to-all", nbytes)
        times.received_bytes += nbytes
        return {p: torch.empty(like.shape, dtype=like.dtype, device=device) for p, like in recv_likes.items()}

    def all_gather(self, tensors, mesh, times: StagingTimes, consume: bool = False, senders: Optional[int] = None):
        senders = mesh.width if senders is None else senders
        for i in range(len(tensors)):
            nbytes = tensors[i].numel() * tensors[i].element_size()
            self.log.record("all-gather", senders * nbytes)
            if consume:
                tensors[i] = None
            yield i, [self.slot[:nbytes]] * senders


def recording_mesh(width: int, device, slot_bytes: int, rank: int = 0) -> DataMesh:
    """The ("data",) mesh of ``width`` ranks a counted step of ``rank`` runs over."""
    return DataMesh(tuple(torch.device(device) for _ in range(width)), None,
                    RecordingExchange(device, slot_bytes, rank) if width > 1 else None)


def recording_axes(mesh, xmesh: DataMesh, rank: int = 0) -> Optional[AxisGroups]:
    """``rank``'s axis groups on ``mesh``, their collectives recorded by
    ``xmesh``'s transport (None on a mesh without a ``model`` axis of more
    than one rank: nothing is split over one)."""
    if xmesh.exchange is None or mesh.shape.get("model", 1) < 2:
        return None
    return axis_groups(mesh, rank, xmesh.exchange)


# ---------------------------------------------------------------------------
# argument bytes under the rules
# ---------------------------------------------------------------------------


def _shard_bytes(sharding: NamedSharding, dtype: torch.dtype) -> int:
    return math.prod(sharding.shard_shape) * torch.empty((), dtype=dtype).element_size()


def _tree_shard_bytes(shardings, tensors) -> int:
    return sum(_shard_bytes(s, t.dtype) for s, t in zip(shardings, tensors, strict=True))


def state_argument_bytes(state: TrainState, mesh, param_axes) -> int:
    """The rank's shard bytes of the state (the largest shard: shards of a
    leaf are equal), each host integer a 4-byte scalar."""
    layout = tensor_shardings(state_shardings(state, mesh, param_axes), state)
    ints = 1 + sum(isinstance(v, int) for v in state.opt_state.values())
    return _tree_shard_bytes(layout, tensor_leaves(state)) + SCALAR_BYTES * ints


def batch_argument_bytes(specs: dict, mesh, accum_steps: int = 1) -> int:
    """The rank's shard bytes of the batch under ``batch_spec``: with
    accumulation, (accum, micro, ...) with the microbatch over the data
    axes, as JAX's dry run lays it."""
    total = 0
    for v in specs.values():
        if accum_steps > 1:
            shape = (accum_steps, v.shape[0] // accum_steps) + tuple(v.shape[1:])
            spec = (None,) + batch_spec(mesh, extra_dims=v.ndim - 1)
        else:
            shape = tuple(v.shape)
            spec = batch_spec(mesh, extra_dims=v.ndim - 1, batch_size=v.shape[0])
        total += _shard_bytes(NamedSharding(mesh, spec, shape), v.dtype)
    return total


# ---------------------------------------------------------------------------
# the rank's work
# ---------------------------------------------------------------------------


def local_batch(specs: dict, rows: int, device) -> dict:
    """A microbatch of the rank's: ``rows`` rows of each input (zeros)."""
    return {k: torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=device) for k, v in specs.items()}


def _stack(batch: dict, accum: int) -> dict:
    """(accum, rows, ...): the layout of a step with accumulation (the
    sharded step's chunk always is)."""
    return {k: v.expand((accum,) + tuple(v.shape)).contiguous() for k, v in batch.items()}


def activation_bytes(model: LanguageModel, params, batch: dict) -> int:
    """Bytes one microbatch's forward leaves alive for its backward: the
    storages its loss's graph keeps (under the config's remat policy)."""
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    with StepCounter() as c:
        total, _ = lm_loss(model, params, batch)
        kept = c.live_bytes - c.live_of(total)
    del total
    return kept


def _memory(arg_bytes: int, counter: StepCounter, outputs, aliased: int, activation: int) -> dict:
    out_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(outputs) if isinstance(t, torch.Tensor))
    fresh_out = counter.live_of(outputs)
    temp = counter.peak_bytes - fresh_out
    return {
        "argument_bytes_per_device": int(arg_bytes),
        "output_bytes_per_device": int(out_bytes),
        "temp_bytes_per_device": int(temp),
        "alias_bytes_per_device": int(aliased),
        "peak_bytes_per_device": int(arg_bytes + out_bytes + temp - aliased),
        "activation_bytes_per_microbatch": int(activation),
    }


def _cost(counter: StepCounter) -> dict:
    return {"flops": float(counter.flops), "bytes_accessed": float(counter.bytes_accessed),
            "kernels": {k: dict(v) for k, v in sorted(counter.kernels.items())}}


def count_train(cfg, shape: InputShape, mesh, *, accum_steps: int = 1, accum_mode: str = "psum_each",
                optimizer_name: str = "momentum", device="meta", rank: int = 0) -> dict:
    """Rank ``rank``'s train step on ``mesh`` (rank 0's by default), a rank
    that computes rows: memory, cost, collectives and the rank's share of
    the work."""
    if shape.global_batch % accum_steps:
        raise ValueError(f"global batch {shape.global_batch} does not split into {accum_steps} microbatches")
    model = LanguageModel(cfg)
    optimizer = make_optimizer(optimizer_name)
    whole, param_axes = abstract_train_state(model, optimizer, device)
    specs = input_specs(cfg, shape)
    args = state_argument_bytes(whole, mesh, param_axes) + batch_argument_bytes(specs, mesh, accum_steps) \
        + 2 * SCALAR_BYTES
    rows, width = rank_rows(shape.global_batch // accum_steps, mesh.size)
    if rank >= width:
        raise ValueError(f"rank {rank} computes no rows ({width} ranks do): its pass on meta tensors is not counted")
    mb = local_batch(specs, rows, device)
    activation = activation_bytes(model, whole.params, mb)
    for w in tree_leaves(whole.params):
        w.requires_grad_(False)
    if mesh.size == 1:
        state, xmesh = whole, None
        step = build_train_step(model, optimizer, accum_steps=accum_steps, mode=accum_mode)
        batch = mb if accum_steps == 1 else _stack(mb, accum_steps)
    else:
        state = reshard_state(whole, mesh, param_axes, rank=rank)
        layout = tensor_shardings(state_shardings(whole, mesh, param_axes), whole)
        largest = max(4 * t.numel() for t in tensor_leaves(whole))
        xmesh = recording_mesh(mesh.size, device, largest, rank)
        n_params = len(tree_leaves(whole.params))
        step = build_sharded_train_step(model, optimizer, layout[:n_params], rank=rank, width=width,
                                        local_accum=accum_steps, xmesh=xmesh, axis=recording_axes(mesh, xmesh, rank))
        batch = _stack(mb, accum_steps)
    del whole
    before = {id(t.untyped_storage()) for t in tensor_leaves(state)}
    with StepCounter() as counter:
        new_state, metrics = step(state, batch, 0.1, 0)
        outputs = [tensor_leaves(new_state), list(metrics.values())]
        aliased = sum(t.numel() * t.element_size() for t in tensor_leaves(new_state)
                      if id(t.untyped_storage()) in before)
        summary = {"memory": _memory(args, counter, outputs, aliased, activation), "cost": _cost(counter)}
    summary["collectives"] = (xmesh.exchange.log if xmesh is not None and xmesh.exchange else CollectiveLog()).summary()
    summary["work"] = {"rows_per_microbatch": rows, "computing_ranks": width, "microbatches": accum_steps,
                       "largest_host_bytes": counter.largest_host_bytes}
    return summary


def count_serve(cfg, shape: InputShape, mesh, device="meta") -> dict:
    """Rank 0's prefill or decode step on ``mesh``: the sharded serving
    forward (``distributed/sharded.sharded_forward``: each layer gathered
    where it runs, an MoE layer's experts over the ``model`` group) on the
    rank's rows of the batch and cache. Its arguments are those the step reads, as XLA keeps only those:
    a prefill overwrites its attention cache unread, a decode reads no
    encoder weight, an RWKV6 decode no cache index."""
    model = LanguageModel(cfg)
    params = abstract_params(model, device)
    param_axes = model.param_axes()
    specs = input_specs(cfg, shape)
    if shape.kind == "decode":
        specs = {"tokens": specs["tokens"]}
    compute = getattr(torch, cfg.compute_dtype)
    b = shape.global_batch
    rows, width = rank_rows(b, mesh.size)
    batch = local_batch(specs, rows, device)
    cache = abstract_cache(model, rows, shape.seq_len, device)
    shardings = tree_leaves(shard_tree(unstack_axes(param_axes, params), params, mesh))
    sharded = mesh.size > 1 and any(not s.replicated for s in shardings)
    mine = _rebuild(params, iter([own_shard(t, s, 0) for t, s in zip(tree_leaves(params), shardings)])) \
        if sharded else params
    xmesh = recording_mesh(mesh.size, device, 1) if sharded else None
    axis = recording_axes(mesh, xmesh) if sharded else None
    index = memory = None
    if shape.kind == "decode":
        # the cache index a row (the engines' form; a scalar would be read on the host)
        index = torch.full((rows,), shape.seq_len - 1, dtype=torch.int32, device=device)
        if cfg.is_encoder_decoder:
            memory = torch.zeros((rows, cfg.encoder_seq, cfg.d_model), dtype=compute, device=device)
    with torch.no_grad(), StepCounter() as counter:
        inputs = {"params": tree_leaves(mine), "cache": tree_leaves(cache), "batch": list(batch.values()),
                  "index": [index] if index is not None else [], "memory": [memory] if memory is not None else []}
        counter.watch([t for ts in inputs.values() for t in ts])
        gathered: set = set()
        if sharded:
            logits, new_cache = sharded_forward(model, mine, shardings, rank=0, width=width, xmesh=xmesh,
                                                kind=shape.kind, batch=batch, cache=cache, cache_index=index,
                                                memory=memory, axis=axis, gathered=gathered)
        elif shape.kind == "prefill":
            logits, new_cache = model.prefill(mine, batch, cache)
        else:
            logits, new_cache = model.decode_step(mine, batch["tokens"], cache, index, memory=memory)
        read = {k: [counter.was_read(t) for t in ts] for k, ts in inputs.items()}
        if sharded:  # a gathered leaf is read (its shards travel; the recording reads none)
            read["params"] = [i in gathered for i in range(len(inputs["params"]))]
        # outputs updated in place in an argument (a cache leaf the step read);
        # a cache it overwrote unread is an output, as in JAX
        kept = {id(t.untyped_storage()) for t, r in zip(inputs["cache"], read["cache"]) if r}
        del inputs
        outputs = [logits, tree_leaves(new_cache)]
        aliased = sum(t.numel() * t.element_size() for t in tree_leaves(new_cache)
                      if id(t.untyped_storage()) in kept)
    args = _read_argument_bytes(model, params, shardings, b, shape, specs, mesh, read)
    summary = {"memory": _memory(args, counter, outputs, aliased, 0), "cost": _cost(counter)}
    summary["collectives"] = (xmesh.exchange.log if xmesh is not None else CollectiveLog()).summary()
    summary["work"] = {"rows_per_microbatch": rows, "computing_ranks": width, "microbatches": 1,
                       "largest_host_bytes": counter.largest_host_bytes}
    return summary


def _read_argument_bytes(model, params, shardings, b: int, shape: InputShape, specs: dict, mesh, read: dict) -> int:
    """The rank's shard bytes of the serving step's arguments that it read
    (``read``: a flag per tensor of each kind), in the JAX layout: the whole
    batch's cache and inputs."""
    total = sum(_shard_bytes(s, t.dtype) for s, t, r in zip(shardings, tree_leaves(params), read["params"]) if r)
    whole_cache = abstract_cache(model, b, shape.seq_len)
    cache_sh = tree_leaves(shard_tree(unstack_axes(model.cache_axes(), whole_cache), whole_cache, mesh))
    total += sum(_shard_bytes(s, t.dtype) for s, t, r in zip(cache_sh, tree_leaves(whole_cache), read["cache"]) if r)
    total += batch_argument_bytes({k: v for (k, v), r in zip(specs.items(), read["batch"]) if r}, mesh)
    total += SCALAR_BYTES * sum(read["index"])
    if any(read["memory"]):
        cfg = model.cfg
        mem = torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=getattr(torch, cfg.compute_dtype), device="meta")
        total += batch_argument_bytes({"memory": mem}, mesh)
    return total


def count_combo(cfg, shape: InputShape, mesh, **kw) -> dict:
    if shape.kind == "train":
        return count_train(cfg, shape, mesh, **kw)
    return count_serve(cfg, shape, mesh, **{k: v for k, v in kw.items() if k == "device"})


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def production_mesh(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod else 256))


def run_combo(arch: str, shape_name: str, multi_pod: bool, *, accum_steps: int = 1,
              accum_mode: str = "psum_each", mesh=None, cfg=None) -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for(arch, shape_name) if cfg is None else cfg
    mesh = production_mesh(multi_pod) if mesh is None else mesh
    t0 = time.time()
    summary = count_combo(cfg, shape, mesh, **(
        {"accum_steps": accum_steps, "accum_mode": accum_mode} if shape.kind == "train" else {}))
    summary.update(
        devices=mesh.size, mesh=dict(mesh.shape),
        arch=arch, shape=shape_name, config=cfg.name, kind=shape.kind,
        multi_pod=multi_pod, compile_seconds=round(time.time() - t0, 1),
        param_counts=cfg.param_counts(), remat_policy=cfg.remat_policy,
        seq_len=shape.seq_len, global_batch=shape.global_batch,
    )
    if shape.kind == "train":
        summary.update(accum_steps=accum_steps, accum_mode=accum_mode)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="false", choices=["false", "true", "both"])
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--accum-mode", default="psum_each", choices=["psum_each", "deferred"])
    ap.add_argument("--out", default="results/torch/dryrun")
    args = ap.parse_args()

    combos = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    pods = {"false": [False], "true": [True], "both": [False, True]}[args.multi_pod]
    for arch in archs:
        for shape in shapes:
            if not shape_applicable(arch, shape):
                log.info("SKIP %s × %s (inapplicable)", arch, shape)
                continue
            for mp in pods:
                combos.append((arch, shape, mp))

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape, mp in combos:
        tag = f"{arch}_{shape}_{'pod2' if mp else 'pod1'}"
        try:
            summary = run_combo(arch, shape, mp, accum_steps=args.accum_steps, accum_mode=args.accum_mode)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(summary, f, indent=1)
            log.info(
                "OK   %-40s peak=%.2f GB/dev flops=%.3e coll=%.3e B (%.0fs)",
                tag,
                summary["memory"]["peak_bytes_per_device"] / 2**30,
                summary["cost"]["flops"],
                summary["collectives"]["total_bytes"],
                summary["compile_seconds"],
            )
        except Exception as e:  # noqa: BLE001
            failures.append((tag, repr(e)))
            log.error("FAIL %s: %s", tag, e)
            traceback.print_exc(limit=8)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {[f[0] for f in failures]}")
    log.info("all %d combos counted", len(combos))


if __name__ == "__main__":
    main()
