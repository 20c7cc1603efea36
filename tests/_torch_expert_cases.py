"""Workers of ``tests/test_torch_expert_parallel.py`` (a module without JAX:
spawned workers import it)."""
import json
import os

import numpy as np

METRICS = ("loss", "aux", "grad_sq_small", "grad_sq_big", "grad_norm")


def _group(rank, world, workdir, device_exchange):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.nccl import DeviceExchange
    from repro_torch.distributed.staging import HostExchange

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                            world_size=world)
    return (DeviceExchange(rank, world, torch.device("cpu"), "gloo") if device_exchange
            else HostExchange(workdir, rank, world, 1 << 22))


def expert_parallel_worker(rank, world, workdir, arch, shape, width, local_accum, device_exchange, updates=3):
    """One of ``world`` CPU workers on a ``shape`` (data, model) host mesh:
    ``updates`` sharded momentum steps (clip 1.0) of ``arch`` smoke in
    float32 with the rank's axis groups, so that an MoE layer's experts
    split over ``model`` are computed over the ``model`` group; ranks ``[0,
    width)`` compute ``local_accum`` microbatches of 2 rows x 8 tokens each,
    the others none. The same updates by the elastic step on one worker
    over all ``width * local_accum`` microbatches. Writes ``result_<rank>``:
    each update's metrics of both runs and, per param leaf, the largest
    difference of this rank's shard from the whole run's slice, the leaf's
    norm and whether their bits are equal."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.reshard import reshard_state, state_shardings
    from repro_torch.distributed.sharded import build_sharded_train_step, own_shard, tensor_leaves, tensor_shardings
    from repro_torch.distributed.step import build_elastic_train_step
    from repro_torch.launch.mesh import make_axis_groups, make_data_mesh, make_host_mesh, prefix_groups
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves, tree_map

    exchange = _group(rank, world, workdir, device_exchange)
    try:
        cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        model = LanguageModel(cfg)
        opt = make_optimizer("momentum", beta=0.9)
        params = model.init(0, device="cpu")
        whole = TrainState(params, opt.init(params), 0)
        mesh = make_host_mesh(*shape, devices=["cpu"] * world)
        groups = prefix_groups(world)
        axis = make_axis_groups(mesh, rank, exchange)
        xmesh = make_data_mesh(world, ["cpu"] * world, groups, exchange)
        layout = tensor_shardings(state_shardings(whole, mesh, model.param_axes()), whole)
        mine = reshard_state(TrainState(tree_map(lambda t: t.clone(), params), opt.init(params), 0), mesh,
                             model.param_axes(), rank)
        n = len(tree_leaves(params))
        step = build_sharded_train_step(model, opt, layout[:n], rank=rank, width=width, local_accum=local_accum,
                                        xmesh=xmesh, grad_clip=1.0, axis=axis)
        ref_step = build_elastic_train_step(model, opt, make_data_mesh(1, ["cpu"]), width=1,
                                            local_accum=width * local_accum, grad_clip=1.0)
        got, want = [], []
        for s in range(updates):
            tokens = np.random.default_rng(s).integers(0, cfg.vocab_size, (width * local_accum, 2, 8))
            tokens = torch.from_numpy(tokens.astype(np.int32))
            if rank < width:
                chunk = {"tokens": tokens[rank * local_accum:(rank + 1) * local_accum]}
            else:
                chunk = {"tokens": torch.empty((local_accum, 2, 8), dtype=torch.int32, device="meta")}
            mine, metrics = step(mine, chunk, 0.05, 0)
            whole, ref = ref_step(whole, {"tokens": tokens}, 0.05, 0)
            got.append({k: float(metrics[k]) for k in METRICS})
            want.append({k: float(ref[k]) for k in METRICS})
        leaves = []
        for a, b, sh in zip(tensor_leaves(mine)[:n], tensor_leaves(whole)[:n], layout[:n], strict=True):
            b_mine = own_shard(b, sh, rank)
            leaves.append({"diff": float((a - b_mine).detach().abs().max()), "norm": float(b.detach().norm()),
                           "equal": bool(torch.equal(a, b_mine))})
        with open(os.path.join(workdir, f"result_{rank}"), "w") as f:
            json.dump({"got": got, "want": want, "leaves": leaves}, f)
    finally:
        dist.destroy_process_group()


def to_all_worker(rank, world, workdir, device_exchange):
    """One of four CPU workers on a (2, 2) host mesh: an all-to-all over the
    rank's ``model`` group of blocks (rank, destination) of a few dtypes,
    and a gather of a chunk over its expert group. Writes ``result_<rank>``
    with the bytes received (as lists), for the test to hold against a
    plain gather."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.staging import StagingTimes
    from repro_torch.launch.mesh import make_axis_groups, make_host_mesh
    from repro_torch.sharding import NamedSharding

    exchange = _group(rank, world, workdir, device_exchange)
    try:
        mesh = make_host_mesh(2, 2, devices=["cpu"] * world)
        axis = make_axis_groups(mesh, rank, exchange)
        g = axis.model
        out = {}
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            sends = [torch.arange(6, dtype=torch.float32).reshape(2, 3).add(100 * rank + 10 * q).to(dtype)
                     for q in range(g.width)]
            likes = {p: torch.empty((2, 3), dtype=dtype, device="meta") for p in range(g.width)}
            got = exchange.to_all(sends, likes, g, StagingTimes(), torch.device("cpu"))
            out[str(dtype)] = {str(p): got[p].float().tolist() for p in sorted(got)}
        # the expert group gathers a (2, 4, 3) chunk whose dimension 1 is split over it
        e = axis.experts
        sub = mesh.submesh(rank, axis.expert_axes)
        sh = NamedSharding(sub, (None, "data", None), (2, 4, 3))
        full = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3) + 1000 * mesh.coords(rank)["model"]
        pos = e.index(rank)
        shard = full[sh.shard_slices(pos)].contiguous()
        like = torch.empty((2, 4, 3), dtype=torch.float32, device="meta")
        holds = sh.holders()[sh.shard_index(pos)] == pos
        (_, gathered), = list(exchange.assemble([shard if holds else None], [sh], [like], e, StagingTimes(),
                                                torch.device("cpu")))
        out["gather_equal"] = bool(torch.equal(gathered, full))
        with open(os.path.join(workdir, f"result_{rank}"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def expert_layer_worker(rank, world, workdir, arch, shape, device_exchange):
    """One of ``world`` CPU workers on a ``shape`` host mesh: the MoE layer
    of ``layer.npz`` (router, expert tensors, and x, one row a rank) stored
    as this rank's shards, gathered as the sharded step gathers a layer (its
    experts over the expert group) and applied to this rank's row with its
    experts computed over the ``model`` group. Writes ``layer_<rank>.npz``:
    y, aux and the dispatch tensor of the rank's row."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharded import ShardTimes, _rebuild, _StepRun, _view, own_shard
    from repro_torch.launch.mesh import make_axis_groups, make_data_mesh, make_host_mesh, prefix_groups
    from repro_torch.models.layers import moe
    from repro_torch.sharding import shard_tree
    from repro_torch.utils.tree import tree_leaves

    exchange = _group(rank, world, workdir, device_exchange)
    try:
        cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        data = np.load(os.path.join(workdir, "layer.npz"))
        tree = {"layer": {"moe": {k: torch.from_numpy(data[k]) for k in ("router", "w_gate", "w_up", "w_down")}}}
        mesh = make_host_mesh(*shape, devices=["cpu"] * world)
        shardings = tree_leaves(shard_tree({"layer": {"moe": moe.param_axes(cfg)}}, tree, mesh))
        mine = _rebuild(tree, iter([own_shard(t, s, rank) for t, s in zip(tree_leaves(tree), shardings)]))
        leaves = tree_leaves(mine)
        xmesh = make_data_mesh(world, ["cpu"] * world, prefix_groups(world), exchange)
        run = _StepRun(leaves, shardings, rank, world, 1, xmesh, ShardTimes(), make_axis_groups(mesh, rank, exchange))
        view = _view(mine, {id(t): i for i, t in enumerate(leaves)}, run, [])
        x = torch.from_numpy(data["x"][rank:rank + 1])
        with torch.no_grad():
            layer = view["layer"].whole()
            split = "group" in layer["moe"]
            y, aux = moe.apply(layer["moe"], x, cfg)
            gs = min(moe.GROUP_SIZE, x.shape[1])
            xg = x.reshape(1, x.shape[1] // gs, gs, -1)
            probs = torch.softmax(torch.einsum("bngd,de->bnge", xg, layer["moe"]["router"]), dim=-1)
            disp, _ = moe.dispatch_tensors(probs, cfg.top_k, moe.capacity_of(cfg, gs))
        np.savez(os.path.join(workdir, f"layer_{rank}.npz"), y=y.numpy(), aux=np.float32(aux), disp=disp.numpy(),
                 split=np.bool_(split), experts=np.int64(layer["moe"]["w_gate"].shape[0]))
    finally:
        dist.destroy_process_group()
