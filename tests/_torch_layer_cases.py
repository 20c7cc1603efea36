"""Workers of ``tests/test_torch_layer_gather.py`` (a module without JAX:
spawned workers import it)."""
import os

import numpy as np


def sharded_vs_whole_worker(rank, world, workdir, width, local_accum, device_exchange):
    """One of ``world`` CPU workers on a (2, 2) host mesh: two sharded
    momentum steps (clip 1.0) of qwen2.5-3b smoke in float32, ranks ``[0,
    width)`` computing ``local_accum`` microbatches of 2 rows x 8 tokens
    each, the others none; the same two steps by the elastic step on one
    worker over all ``width * local_accum`` microbatches. Writes ``ok_<rank>``
    when the metrics and this rank's shards of the params and the momentum
    equal the whole run's bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.nccl import DeviceExchange
    from repro_torch.distributed.reshard import reshard_state, state_shardings
    from repro_torch.distributed.sharded import build_sharded_train_step, own_shard, tensor_leaves, tensor_shardings
    from repro_torch.distributed.staging import HostExchange
    from repro_torch.distributed.step import build_elastic_train_step
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh, prefix_groups
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves, tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                            world_size=world)
    try:
        from repro_torch.configs import get_config

        cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
        model = LanguageModel(cfg)
        opt = make_optimizer("momentum", beta=0.9)
        params = model.init(0, device="cpu")
        whole = TrainState(params, opt.init(params), 0)
        mesh = make_host_mesh(2, 2, devices=["cpu"] * world)
        groups = prefix_groups(world)
        exchange = (DeviceExchange(rank, world, torch.device("cpu"), "gloo") if device_exchange
                    else HostExchange(workdir, rank, world, 1 << 22))
        xmesh = make_data_mesh(world, ["cpu"] * world, groups, exchange)
        layout = tensor_shardings(state_shardings(whole, mesh, model.param_axes()), whole)
        mine = reshard_state(TrainState(tree_map(lambda t: t.clone(), params), opt.init(params), 0), mesh,
                             model.param_axes(), rank)
        step = build_sharded_train_step(model, opt, layout[:len(tree_leaves(params))], rank=rank, width=width,
                                        local_accum=local_accum, xmesh=xmesh, grad_clip=1.0)
        ref_step = build_elastic_train_step(model, opt, make_data_mesh(1, ["cpu"]), width=1,
                                            local_accum=width * local_accum, grad_clip=1.0)
        same = True
        for s in range(2):
            tokens = np.random.default_rng(s).integers(0, cfg.vocab_size, (width * local_accum, 2, 8))
            tokens = torch.from_numpy(tokens.astype(np.int32))
            if rank < width:
                chunk = {"tokens": tokens[rank * local_accum:(rank + 1) * local_accum]}
            else:
                chunk = {"tokens": torch.empty((local_accum, 2, 8), dtype=torch.int32, device="meta")}
            mine, metrics = step(mine, chunk, 0.05, 0)
            whole, ref = ref_step(whole, {"tokens": tokens}, 0.05, 0)
            same = same and all(torch.equal(metrics[k], ref[k]) for k in
                                ("loss", "aux", "grad_sq_small", "grad_sq_big", "grad_norm"))
        pairs = zip(tensor_leaves(mine), tensor_leaves(whole), layout, strict=True)
        same = same and all(torch.equal(a, own_shard(b, sh, rank)) for a, b, sh in pairs)
        if same:
            open(os.path.join(workdir, f"ok_{rank}"), "w").write("ok")
    finally:
        dist.destroy_process_group()
