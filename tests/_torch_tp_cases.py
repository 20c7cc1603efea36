"""Workers of ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tp_recurrent.py`` (a module without JAX: spawned workers
import it). One spawn a mesh shape runs every case of that shape, in
order, and writes ``result_<rank>`` (JSON) and, for the layer cases,
``layer_<rank>.npz`` and ``recurrent_<rank>.npz``."""
import hashlib
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


def _batch(cfg, s, width, local_accum, rows, seq):
    """Update ``s``'s chunk for every model group, (width * local_accum,
    rows, ...) leaves: tokens, and internvl2's vision embeddings."""
    import torch

    rng = np.random.default_rng(s)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (width * local_accum, rows, seq))
                                        .astype(np.int32))}
    if cfg.num_vision_tokens:
        vis = rng.standard_normal((width * local_accum, rows, cfg.num_vision_tokens, 1024)).astype(np.float32)
        batch["vision_embeds"] = torch.from_numpy(vis)
    return batch


def _train(ctx, arch, overrides, width, local_accum, updates, reduce_scatter, rows=2, seq=8, resync=False):
    """``updates`` sharded momentum steps (clip 1.0) of ``arch`` smoke (f32,
    ``overrides``) with tensor parallelism over the mesh's model groups,
    groups ``[0, width)`` taking ``local_accum`` microbatches of ``rows`` x
    ``seq`` each; the same updates by the elastic step on one worker over
    every microbatch. Returns each update's metrics of both runs, per param
    leaf (its name) the largest difference of this rank's shard from the
    whole run's slice, the leaf's norm, how far it moved from its initial
    value and whether the bits are equal, a digest of this rank's params,
    the bytes it received and the boundaries' host seconds. An MoE model's
    routing (``moe.dispatch_tensors``: each token's capacity slot at each
    expert, every call of the forward and the recomputation) is recorded in
    both runs, and ``dispatch`` says whether the sharded run's equal the
    whole run's calls on the same microbatches, to the integer. With
    ``resync`` each update starts the sharded step from the whole run's
    state (its shards of the params and the momentum): each update's
    metrics and the last update's leaves are then one step's differences
    from the same state, which a run whose trajectory magnifies rounding
    (rwkv6 smoke) needs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.reshard import reshard_state, state_shardings
    from repro_torch.distributed.sharded import (
        build_sharded_train_step,
        own_shard,
        tensor_leaves,
        tensor_parallel,
        tensor_shardings,
    )
    from repro_torch.distributed.step import build_elastic_train_step
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves, tree_map

    rank, mesh, axis, xmesh = ctx["rank"], ctx["mesh"], ctx["axis"], ctx["xmesh"]
    cfg = get_config(arch, "smoke").replace(compute_dtype="float32", tp_reduce_scatter=reduce_scatter, **overrides)
    model = LanguageModel(cfg)
    opt = make_optimizer("momentum", beta=0.9)
    params = model.init(0, device="cpu")
    names = _leaf_names(params)
    whole = TrainState(params, opt.init(params), 0)
    layout = tensor_shardings(state_shardings(whole, mesh, model.param_axes()), whole)
    mine = reshard_state(TrainState(tree_map(lambda t: t.clone(), params), opt.init(params), 0), mesh,
                         model.param_axes(), rank)
    n = len(tree_leaves(params))
    times = []
    step = build_sharded_train_step(model, opt, layout[:n], rank=rank, width=width, local_accum=local_accum,
                                    xmesh=xmesh, grad_clip=1.0, axis=axis, tp=tensor_parallel(model, params, mesh),
                                    times=times)
    ref_step = build_elastic_train_step(model, opt, make_data_mesh(1, ["cpu"]), width=1,
                                        local_accum=width * local_accum, grad_clip=1.0)
    initial = [t.clone() for t in tensor_leaves(whole)[:n]]
    row = rank // mesh.shape["model"]
    got, want = [], []
    routes, dispatch = _record_dispatch(), []
    for s in range(updates):
        batch = _batch(cfg, s, width, local_accum, rows, seq)
        if row < width:
            chunk = {k: v[row * local_accum:(row + 1) * local_accum] for k, v in batch.items()}
        else:
            chunk = {k: torch.empty((local_accum,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
                     for k, v in batch.items()}
        routes.clear()
        mine, metrics = step(mine, chunk, 0.05, 0)
        split = list(routes)
        routes.clear()
        whole, ref = ref_step(whole, batch, 0.05, 0)
        if split or routes:  # each microbatch makes the same calls, forward and recomputation
            per = len(routes) // (width * local_accum)
            same = routes[row * local_accum * per:(row + 1) * local_accum * per]
            dispatch.append(len(split) == len(same) > 0 and all(torch.equal(a, b) for a, b in zip(split, same)))
        got.append({k: float(metrics[k]) for k in METRICS})
        want.append({k: float(ref[k]) for k in METRICS})
        if resync and s < updates - 1:
            mine = reshard_state(TrainState(tree_map(lambda t: t.detach().clone(), whole.params),
                                            tree_map(_clone, whole.opt_state), whole.step), mesh,
                                 model.param_axes(), rank)
    leaves = []
    for name, a, b, b0, sh in zip(names, tensor_leaves(mine)[:n], tensor_leaves(whole)[:n], initial, layout[:n],
                                  strict=True):
        b_mine = own_shard(b, sh, rank)
        leaves.append({"name": name, "diff": float((a - b_mine).detach().abs().max()),
                       "norm": float(b.detach().norm()), "moved": float((b - b0).detach().abs().max()),
                       "equal": bool(torch.equal(a, b_mine))})
    digest = hashlib.sha256(b"".join(t.detach().numpy().tobytes() for t in tensor_leaves(mine)[:n])).hexdigest()
    _record_dispatch(stop=True)
    return {"got": got, "want": want, "leaves": leaves, "digest": digest, "dispatch": dispatch,
            "received": sum(t.exchange.received_bytes for t in times),
            "boundary_s": sum(t.boundary_s for t in times)}


def _clone(x):
    return x.detach().clone() if hasattr(x, "detach") else x


def _record_dispatch(stop=False):
    """Records each real (not meta) call of ``moe.dispatch_tensors`` as
    (..., T, E) int64: the token's capacity slot at the expert plus one, 0
    where it holds none. Returns the list the calls go to; ``stop`` puts the
    function back."""
    import torch

    from repro_torch.models.layers import moe

    plain = getattr(moe.dispatch_tensors, "plain", moe.dispatch_tensors)
    if stop:
        moe.dispatch_tensors = plain
        return None
    calls = []

    def recorded(probs, top_k, capacity):
        disp, combine = plain(probs, top_k, capacity)
        if disp.device.type != "meta":
            slots = torch.arange(1, capacity + 1, dtype=disp.dtype, device=disp.device)
            calls.append((disp.detach() * slots).sum(-1).round().long())
        return disp, combine

    recorded.plain = plain
    moe.dispatch_tensors = recorded
    return calls


def _leaf_names(params, prefix=""):
    if isinstance(params, dict):
        return [n for k, v in params.items() for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(params, list):
        return [n for i, v in enumerate(params) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _layer(ctx, workdir):
    """The attention and MLP layer of ``dense_layer.npz`` (qwen smoke, f32)
    stored as this rank's shards, gathered as the step gathers a layer (the
    split leaves over the expert group) and applied over the model group
    to the rank's block of x; writes the gathered outputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharded import ShardTimes, TensorParallel, _rebuild, _StepRun, _view, own_shard
    from repro_torch.models.layers import attention, mlp
    from repro_torch.sharding import shard_tree
    from repro_torch.sharding.partitioning import axes_leaves, compute_split_dim
    from repro_torch.utils.tree import tree_leaves

    rank, mesh = ctx["rank"], ctx["mesh"]
    cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    data = np.load(os.path.join(workdir, "dense_layer.npz"))
    tree = {"layer": {"attn": {k: torch.from_numpy(data[k]) for k in attention.param_axes(cfg)},
                      "mlp": {k: torch.from_numpy(data[k]) for k in mlp.param_axes(cfg)}}}
    axes = {"layer": {"attn": attention.param_axes(cfg), "mlp": mlp.param_axes(cfg)}}
    shardings = tree_leaves(shard_tree(axes, tree, mesh))
    tp = TensorParallel(tuple(compute_split_dim(a, s.spec) for a, s in zip(axes_leaves(axes), shardings)))
    mine = _rebuild(tree, iter([own_shard(t, s, rank) for t, s in zip(tree_leaves(tree), shardings)]))
    leaves = tree_leaves(mine)
    run = _StepRun(leaves, shardings, rank, mesh.size // mesh.shape["model"], 1, ctx["xmesh"], ShardTimes(),
                   ctx["axis"], tp)
    view = _view(mine, {id(t): i for i, t in enumerate(leaves)}, run, [])
    x = torch.from_numpy(data["x"])
    group = run.tensor
    with torch.no_grad():
        layer = view["layer"].whole()
        group.seq = x.shape[1]
        pos = torch.arange(x.shape[1])[None, :]
        y_attn, _ = attention.apply(layer["attn"], group.slice(x), cfg, positions=pos)
        y_mlp = mlp.apply(layer["mlp"], group.slice(x))
        np.savez(os.path.join(workdir, f"layer_{rank}.npz"), attn=group.gather(y_attn).numpy(),
                 mlp=group.gather(y_mlp).numpy(), heads=np.int64(layer["attn"]["wq"].shape[1]),
                 hidden=np.int64(layer["mlp"]["w_up"].shape[1]))
    return {}


def _loss(ctx, z_loss):
    """qwen smoke's loss (f32, ``z_loss``) over the model group with the
    vocabulary-parallel cross-entropy, params ``model.init(0)`` stored as
    shards, on rows 0-1 of update 0's batch of :func:`_batch`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.reshard import state_shardings
    from repro_torch.distributed.sharded import ShardTimes, _rebuild, _StepRun, _view, own_shard, tensor_parallel
    from repro_torch.models import LanguageModel
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves

    rank, mesh = ctx["rank"], ctx["mesh"]
    cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    params = model.init(0, device="cpu")
    layout = tree_leaves(state_shardings(TrainState(params, {}, 0), mesh, model.param_axes()).params)
    mine = _rebuild(params, iter([own_shard(t, s, rank) for t, s in zip(tree_leaves(params), layout)]))
    leaves = tree_leaves(mine)
    run = _StepRun(leaves, layout, rank, mesh.size // mesh.shape["model"], 1, ctx["xmesh"], ShardTimes(),
                   ctx["axis"], tensor_parallel(model, params, mesh))
    view = _view(mine, {id(t): i for i, t in enumerate(leaves)}, run, [])
    view["tp"] = run.tensor
    tokens = _batch(cfg, 0, 1, 1, 2, 8)["tokens"][0]
    with torch.no_grad():
        total, m = lm_loss(model, view, {"tokens": tokens}, z_loss=z_loss)
    return {"total": float(total), "loss": float(m["loss"])}


def _recurrent(ctx, workdir):
    """The rwkv6 time and channel mix (rwkv6 smoke) and Mamba2 (zamba2
    smoke) of ``recurrent.npz``, f32, stored as this rank's shards,
    gathered as the step gathers a layer and applied over the model group:
    the time mix and Mamba2 over the sequence from the file's cache, then a
    decode step from the cache they leave (the rank's heads of the state;
    Mamba2's conv window of its x channels and all of B and C); the
    channel mix over the sequence. Writes the gathered outputs and the
    rank's caches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharded import (
        ShardTimes,
        TensorParallel,
        _rebuild,
        _StepRun,
        _view,
        local_cache,
        own_shard,
    )
    from repro_torch.models import LanguageModel
    from repro_torch.models.layers import mamba2, rwkv6
    from repro_torch.sharding import shard_tree
    from repro_torch.sharding.partitioning import axes_leaves, axes_paths, compute_split_dim
    from repro_torch.utils.tree import tree_leaves

    rank, mesh = ctx["rank"], ctx["mesh"]
    data = np.load(os.path.join(workdir, "recurrent.npz"))
    out = {}
    for arch, keys in (("rwkv6-1.6b", ("tmix", "cmix")), ("zamba2-2.7b", ("mamba",))):
        cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        model = LanguageModel(cfg)
        axes = {"tmix": rwkv6.time_mix_axes(cfg), "cmix": rwkv6.channel_mix_axes(cfg), "mamba": mamba2.param_axes(cfg)}
        axes = {"layer": {k: axes[k] for k in keys}}
        tree = {"layer": {k: {n: torch.from_numpy(data[f"{k}.{n}"]) for n in axes["layer"][k]} for k in keys}}
        shardings = tree_leaves(shard_tree(axes, tree, mesh))
        tp = TensorParallel(tuple(compute_split_dim(a, sh.spec, p)
                                  for a, p, sh in zip(axes_leaves(axes), axes_paths(axes), shardings)))
        mine = _rebuild(tree, iter([own_shard(t, s, rank) for t, s in zip(tree_leaves(tree), shardings)]))
        leaves = tree_leaves(mine)
        run = _StepRun(leaves, shardings, rank, mesh.size // mesh.shape["model"], 1, ctx["xmesh"], ShardTimes(),
                       ctx["axis"], tp)
        view = _view(mine, {id(t): i for i, t in enumerate(leaves)}, run, [])
        group = run.tensor
        x, x1 = torch.from_numpy(data["x"]), torch.from_numpy(data["x1"])
        b, s = x.shape[:2]
        cache = local_cache(model, mesh, b, s + 1, torch.float32, "cpu")["seg0"]["b0"][0]
        with torch.no_grad():
            layer = view["layer"].whole()
            group.seq = s
            if arch == "rwkv6-1.6b":
                h = cfg.d_model // cfg.rwkv_head_dim // group.width
                rc = {"wkv": torch.from_numpy(data["wkv"])[:, group.me * h:(group.me + 1) * h],
                      "shift_t": torch.from_numpy(data["shift_t"]), "shift_c": torch.from_numpy(data["shift_c"])}
                assert rc["wkv"].shape == cache["rwkv"]["wkv"].shape
                y, wkv, shift = rwkv6.apply_time_mix(layer["tmix"], group.slice(x), cfg, cache=rc)
                out["tmix"] = group.gather(y)
                yc, shift_c = rwkv6.apply_channel_mix(layer["cmix"], group.slice(x), cfg, cache=rc)
                out["cmix"], out["cmix_shift"] = group.gather(yc), shift_c
                group.seq = 1
                y1, wkv1, _ = rwkv6.apply_time_mix(layer["tmix"], group.slice(x1), cfg,
                                                   cache={"wkv": wkv, "shift_t": shift}, decode=True)
                out["tmix_decode"], out["wkv"], out["wkv_decode"] = group.gather(y1), wkv, wkv1
            else:
                d_in = cfg.ssm_expand * cfg.d_model
                h = d_in // cfg.ssm_head_dim // group.width
                c = h * cfg.ssm_head_dim
                conv = torch.from_numpy(data["conv"])
                mc = {"ssm": torch.from_numpy(data["ssm"])[:, group.me * h:(group.me + 1) * h],
                      "conv": torch.cat([conv[..., group.me * c:(group.me + 1) * c], conv[..., d_in:]], dim=-1)}
                assert all(mc[k].shape == cache["mamba"][k].shape for k in mc)
                y, mc = mamba2.apply(layer["mamba"], group.slice(x), cfg, cache=mc)
                out["mamba"], out["ssm"], out["conv"] = group.gather(y), mc["ssm"], mc["conv"]
                group.seq = 1
                y1, mc = mamba2.apply(layer["mamba"], group.slice(x1), cfg, cache=mc,
                                      cache_index=torch.full((b,), s, dtype=torch.int32))
                out["mamba_decode"], out["ssm_decode"], out["conv_decode"] = group.gather(y1), mc["ssm"], mc["conv"]
    np.savez(os.path.join(workdir, f"recurrent_{rank}.npz"), **{k: v.numpy() for k, v in out.items()})
    return {}


def tp_worker(rank, world, workdir, shape, cases, device_exchange=False):
    """One of ``world`` CPU workers on a ``shape`` (data, model) host mesh
    with its axis groups: runs ``cases`` ((name, kind, kwargs) triples:
    ``train``, ``layer``, ``loss``, ``recurrent``) in order, and writes
    their results."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_axis_groups, make_data_mesh, make_host_mesh, prefix_groups

    exchange = _group(rank, world, workdir, device_exchange)
    try:
        mesh = make_host_mesh(*shape, devices=["cpu"] * world)
        ctx = {"rank": rank, "mesh": mesh, "axis": make_axis_groups(mesh, rank, exchange),
               "xmesh": make_data_mesh(world, ["cpu"] * world, prefix_groups(world), exchange)}
        out = {}
        for name, kind, kw in cases:
            if kind == "train":
                out[name] = _train(ctx, **kw)
            elif kind == "layer":
                out[name] = _layer(ctx, workdir)
            elif kind == "recurrent":
                out[name] = _recurrent(ctx, workdir)
            else:
                out[name] = _loss(ctx, **kw)
        with open(os.path.join(workdir, f"result_{rank}"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
