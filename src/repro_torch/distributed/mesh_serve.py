"""Greedy serving on a mesh of worker processes: the sharded forward
(``sharded.sharded_forward``) driven through a prefill and decode steps.

:func:`serve_on_mesh` spawns one worker a rank of ``mesh`` (the mesh
trainer's harness, ``procs.py``: ``torch.multiprocessing`` spawn, gloo over a
``FileStore`` in a temporary directory, the host slots or NCCL as
``staging.make_exchange`` chooses, errors back with the failing worker's
traceback). Each worker stores its shards of the params under the sharding
rules, takes rows ``[r * rows, (r + 1) * rows)`` of the prompts where it
has rows (a rank without rows runs on meta tensors of a computing rank's
shapes, serving its shards to every gather and its experts to its
``model`` group), prefills a dense cache, then decodes greedily: each
layer is gathered where it runs, an MoE layer's experts split over
``model`` are computed over the rank's ``model`` group. The launcher's
serving path stays single-process; this is the sharded forward as code
that runs, which the dry run's serving counts measure.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.procs import (
    apply_settings,
    caller_settings,
    fail_worker,
    join_workers,
    slot_bytes,
    stop_workers,
)
from repro_torch.distributed.reshard import state_shardings
from repro_torch.distributed.sharded import _rebuild, own_shard, sharded_forward
from repro_torch.distributed.staging import make_exchange
from repro_torch.launch.mesh import make_axis_groups, make_data_mesh, prefix_groups, rank_rows
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves


def _worker(rank: int, job: dict, runs: list) -> None:
    import torch.distributed as dist

    workdir = job["workdir"]
    try:
        apply_settings(job["settings"])
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        mesh = job["mesh"]
        device = mesh.device_of(rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        world = mesh.size
        dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                                world_size=world, timeout=timedelta(seconds=job["timeout"]))
        try:
            groups = prefix_groups(world)
            exchange = make_exchange(workdir, rank, world, job["slot_bytes"], mesh.device_list)
            axis = make_axis_groups(mesh, rank, exchange) if mesh.shape.get("model", 1) > 1 else None
            xmesh = make_data_mesh(world, mesh.device_list, groups, exchange)
            for i, (model, params, tokens) in enumerate(runs):
                _serve(i, rank, job, model, params, tokens, xmesh, axis, device)
                runs[i] = None
        finally:
            dist.destroy_process_group()
    except BaseException:
        fail_worker(workdir, rank)


def _serve(i: int, rank: int, job: dict, model, params, tokens: np.ndarray, xmesh, axis, device) -> None:
    """Run ``i``: this worker's shards of ``params``, its rows of
    ``tokens``, a prefill and greedy decode steps; its logits saved."""
    mesh = job["mesh"]
    layout = tree_leaves(state_shardings(TrainState(params, {}, 0), mesh, model.param_axes()).params)
    mine = _rebuild(params, iter([own_shard(t.to(device), s, rank) for t, s in zip(tree_leaves(params), layout)]))
    del params
    rows, width = rank_rows(tokens.shape[0], mesh.size)
    new, s = job["new_tokens"], tokens.shape[1]
    computes = rank < width
    on = device if computes else torch.device("meta")
    cache = model.init_cache(rows, s + new, dtype=job["cache_dtype"], device=on)
    if computes:
        batch = {"tokens": torch.from_numpy(tokens[rank * rows:(rank + 1) * rows]).to(device)}
    else:
        batch = {"tokens": torch.empty((rows, s), dtype=torch.int32, device="meta")}

    def forward(kind, batch, cache, index=None):
        return sharded_forward(model, mine, layout, rank=rank, width=width, xmesh=xmesh, kind=kind, batch=batch,
                               cache=cache, cache_index=index, axis=axis)

    logits, cache = forward("prefill", batch, cache)
    out = [logits]
    for t in range(new - 1):
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        index = torch.full((rows,), s + t, dtype=torch.int32, device=on)
        logits, cache = forward("decode", {"tokens": nxt}, cache, index)
        out.append(logits)
    if computes:
        torch.save([x.float().cpu() for x in out], os.path.join(job["workdir"], f"logits_{i}_{rank}.pt"))


def serve_on_mesh(mesh, runs: list, new_tokens: int, *, cache_dtype=torch.float32, timeout: float = 120.0,
                  deadline: Optional[float] = None) -> list:
    """Greedy decoding on ``mesh``'s workers of each of ``runs``, (model,
    params, tokens) triples served one after another by the same workers
    (one spawn for them all): each worker stores its shards of ``params``
    (a whole tree, any device: each worker copies its shards to its own),
    and ``tokens`` (B, S) spread over the ranks as the dry run spreads rows
    (``launch/mesh.rank_rows``). Returns, for each run, the logits of the
    prefill and of each of the ``new_tokens - 1`` decode steps, each (B, 1,
    V) f32 on the host, rows in rank order."""
    runs = [(model, params, np.asarray(tokens, np.int32)) for model, params, tokens in runs]
    if any(d.type == "cuda" for d in mesh.device_list):
        from repro_torch.kernels import _cuda

        _cuda.build()  # the workers load what the parent built
    workdir = tempfile.mkdtemp(prefix="mesh_serve_")
    try:
        job = {"workdir": workdir, "mesh": mesh, "new_tokens": new_tokens, "cache_dtype": cache_dtype,
               "settings": caller_settings(), "timeout": timeout,
               "slot_bytes": max(slot_bytes(TrainState(params, {}, 0)) for _, params, _ in runs)}
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_worker, args=(r, job, runs), name=f"mesh-serve-{r}") for r in range(mesh.size)]
        try:
            for p in procs:
                p.start()
        except BaseException:
            stop_workers([p for p in procs if p.pid is not None])
            raise
        join_workers(procs, workdir, deadline)
        out = []
        for i, (_, _, tokens) in enumerate(runs):
            width = rank_rows(tokens.shape[0], mesh.size)[1]
            parts = [torch.load(os.path.join(workdir, f"logits_{i}_{r}.pt")) for r in range(width)]
            out.append([torch.cat([part[k] for part in parts]) for k in range(new_tokens)])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out
