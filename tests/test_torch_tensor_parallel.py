"""Tensor parallelism over the mesh's ``model`` groups
(``repro_torch/distributed/sharded.py``'s ``TensorParallel``), on the CPU:
attention heads, the dense MLPs' hidden dimension and the vocabulary split
over each ``model`` group, the residual carry sequence-parallel between
blocks, as the JAX package's GSPMD splits a dense decoder.

- gloo workers, one spawn a mesh shape running every case of that shape
  (``tests/_torch_tp_cases.py``): qwen2.5-3b smoke (f32) on (1, 2), (2, 2)
  and (1, 4) through the sharded step against the elastic step's whole run
  on one worker over the same microbatches, 6 updates: losses within 1e-6
  relative, ``grad_sq_small`` and ``grad_sq_big`` within 1e-5, every param
  leaf within 1e-6 of its norm. (1, 4) runs 9 positions (the carry padded
  to 12): 4 query heads over 2 kv heads (each rank projects the kv head its
  query head reads), and 6 heads, which split the query rows instead.
  ``tp_reduce_scatter`` gives the same bits with fewer bytes received; a
  ``model`` group without rows replays; internvl2's vision projector, whose
  gradient is a partial over each group, is held where a double sum over
  ``model`` would break it;
- the split layer (attention and MLP) against the JAX package's
  ``attention.apply`` / ``mlp.apply``, the vocabulary-parallel loss against
  JAX's ``lm_loss``;
- the MoE family (dbrx and arctic smoke, f32, in the (2, 2) spawn at 9
  positions): losses, the aux loss and leaves within 1e-6, every layer's
  dispatch integer-equal to the unsharded run's, ``tp_reduce_scatter``
  bit-equal, a model group without rows, the recorded bytes;
- ``SEBSTrainer(mesh=(1, 2), tensor_parallel=True)`` against the same
  schedule in one process, and ``serve_on_mesh(..., tensor_parallel=True)``
  (the dense decoders and the MoE family) against the single-process
  engine's greedy calls;
- the dry run: a smoke step's recorded collectives equal to a gloo run's
  received bytes, fewer under ``tp_reduce_scatter``; qwen2.5-3b train_4k
  and prefill_32k at full width on (16, 16) on every rank;
- ``tensor_parallel=True`` on the family it does not cover (whisper)
  raises, naming its ``ROADMAP.md`` item; the recurrent families (rwkv6,
  zamba2) are in ``tests/test_torch_tp_recurrent.py``, hillclimb's
  ``tp_rs`` in ``tests/test_torch_roofline.py``.

76-111 s on one worker, host-dependent (five spawns of gloo workers; the
MoE cases add ~5 s to the (2, 2) spawn and the serving test ~2 s).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_tp_cases import tp_worker  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import LanguageModel as JaxModel  # noqa: E402
from repro.models.layers import attention as jattention  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.train.loss import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402

LOSS_RTOL = 1e-6
SQ_RTOL = 1e-5
LEAF_TOL = 1e-6
SEQ = 8
MOE = ("dbrx-132b", "arctic-480b")
MOE_SEQ = 9  # the carry padded to 10 over a model group of 2: the pad rows must take no capacity


def _train(name, width, local_accum, updates=6, arch="qwen2.5-3b", rs=False, seq=SEQ, rows=2, **overrides):
    return (name, "train", {"arch": arch, "overrides": overrides, "width": width, "local_accum": local_accum,
                            "updates": updates, "reduce_scatter": rs, "seq": seq, "rows": rows})


def _spawn(tmp, shape, cases, device_exchange=False):
    world = shape[0] * shape[1]
    torch.multiprocessing.spawn(tp_worker, args=(world, str(tmp), shape, cases, device_exchange), nprocs=world,
                                join=True)
    return [json.loads((tmp / f"result_{r}").read_text()) for r in range(world)]


def _layer_inputs(tmp):
    cfg = get_config("qwen2.5-3b", "smoke")
    rng = np.random.default_rng(5)
    d, h, kv, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    layer = {"wq": rng.standard_normal((d, h, hd)) * d**-0.5, "wk": rng.standard_normal((d, kv, hd)) * d**-0.5,
             "wv": rng.standard_normal((d, kv, hd)) * d**-0.5, "wo": rng.standard_normal((h, hd, d)) * (h * hd)**-0.5,
             "bq": rng.standard_normal((h, hd)) * 0.1, "bk": rng.standard_normal((kv, hd)) * 0.1,
             "bv": rng.standard_normal((kv, hd)) * 0.1, "w_gate": rng.standard_normal((d, f)) * d**-0.5,
             "w_up": rng.standard_normal((d, f)) * d**-0.5, "w_down": rng.standard_normal((f, d)) * f**-0.5,
             "x": rng.standard_normal((2, 11, d))}
    layer = {k: v.astype(np.float32) for k, v in layer.items()}
    np.savez(tmp / "dense_layer.npz", **layer)
    return layer


@pytest.fixture(scope="module")
def run_12(tmp_path_factory):
    """(1, 2), through the device exchange's code over gloo."""
    tmp = tmp_path_factory.mktemp("tp12")
    layer = _layer_inputs(tmp)
    cases = [_train("smoke", 1, 2), _train("smoke_rs", 1, 2, rs=True), ("layer", "layer", {}),
             ("loss", "loss", {"z_loss": 1e-4}), _train("vision", 1, 2, arch="internvl2-1b", seq=12)]
    return _spawn(tmp, (1, 2), cases, device_exchange=True), tmp, layer


@pytest.fixture(scope="module")
def run_22(tmp_path_factory):
    """(2, 2) through the host slots; "bytes" is the dry run's smoke step."""
    tmp = tmp_path_factory.mktemp("tp22")
    cases = [_train("smoke", 2, 1), _train("idle", 1, 2, updates=3), _train("bytes", 2, 1, updates=1, rows=4),
             _train("bytes_rs", 2, 1, updates=1, rows=4, rs=True)]
    for arch in MOE:
        cases += [_train(arch, 2, 1, updates=3, arch=arch, seq=MOE_SEQ),
                  _train(arch + "_rs", 2, 1, updates=3, arch=arch, seq=MOE_SEQ, rs=True)]
    cases.append(_train("moe_idle", 1, 2, updates=2, arch="arctic-480b", seq=MOE_SEQ))
    cases.append(_train("moe_bytes", 2, 1, updates=1, rows=4, arch="arctic-480b", seq=MOE_SEQ))
    return _spawn(tmp, (2, 2), cases)


@pytest.fixture(scope="module")
def run_14(tmp_path_factory):
    """(1, 4) at 9 positions (the carry padded to 12): 4 query heads over 2
    kv heads, and 6 heads (the query-row split)."""
    tmp = tmp_path_factory.mktemp("tp14")
    cases = [_train("smoke", 1, 2, seq=9), _train("smoke_rs", 1, 2, seq=9, rs=True),
             _train("rows", 1, 2, seq=9, num_heads=6)]
    return _spawn(tmp, (1, 4), cases)


def _scale(leaves, leaf) -> float:
    """The scale a leaf's difference is held to: its norm; for an attention
    layer's key bias ``bk`` also the norm of the same layer's ``wk``. The
    key bias adds q . bk to every logit of a query row alike, which the
    softmax removes; only RoPE's rotation of the key leaves a remainder, so
    its gradient is a small residue of products at ``wk``'s scale, and
    their f32 rounding is relative to that scale, not to ``bk``'s own norm
    (the 6-head query-row split: 8.7e-10 from the one-process run, whose
    own ``bk`` is 4.9e-10 from the same run in float64; ``bk``'s norm
    4.7e-4, its ``wk``'s 9.1)."""
    if not leaf["name"].endswith(".attn.bk"):
        return leaf["norm"]
    wk = leaf["name"][:-len("bk")] + "wk"
    return max(leaf["norm"], next(x["norm"] for x in leaves if x["name"] == wk))


def _check(results, name):
    bits = True
    for r, res in enumerate(results):
        run = res[name]
        assert len(run["got"]) == len(run["want"]) > 0
        for got, want in zip(run["got"], run["want"], strict=True):
            for k, tol in (("loss", LOSS_RTOL), ("aux", LOSS_RTOL), ("grad_sq_small", SQ_RTOL),
                           ("grad_sq_big", SQ_RTOL), ("grad_norm", SQ_RTOL)):
                assert abs(got[k] - want[k]) <= tol * abs(want[k]), (name, r, k, got[k], want[k])
        for leaf in run["leaves"]:
            assert leaf["diff"] <= LEAF_TOL * _scale(run["leaves"], leaf), (name, r, leaf)
        bits = bits and all(leaf["equal"] for leaf in run["leaves"])
    print(f"{name}: bit-identical to the unsharded run: {bits}")
    return results


def _results(request, shape: str) -> list:
    """Every rank's results of the spawn of mesh ``shape`` ("1x2", ...)."""
    run = request.getfixturevalue("run_" + shape.replace("x", ""))
    return run[0] if shape == "1x2" else run


@pytest.mark.parametrize("shape", ["1x2", "2x2", "1x4"])
def test_smoke_run_holds_the_unsharded_run(shape, request):
    _check(_results(request, shape), "smoke")


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_reduce_scatter_gives_the_same_bits_with_fewer_bytes(shape, request):
    for res in _results(request, shape):
        base, rs = res["smoke"], res["smoke_rs"]
        assert rs["digest"] == base["digest"] and rs["got"] == base["got"]
        assert rs["received"] < base["received"]


def test_query_rows_split_where_heads_do_not_divide_the_group(run_14):
    """6 heads over 4 ranks: every head on each rank's query rows against
    the key prefix, at 9 positions (the carry padded to 12): losses within
    1e-6 relative, every leaf within 1e-6 of its norm."""
    _check(run_14, "rows")


@pytest.mark.parametrize("arch", MOE)
def test_moe_family_splits_over_model_groups(arch, run_22):
    """dbrx and arctic smoke (f32, 9 positions) on (2, 2), two model
    groups of 2 ranks, 3 momentum updates: each rank gathers its group's
    sequence, routes the whole routing group, runs its 2 of the 4 experts
    (and its half of arctic's residual MLP) and sums one partial over the
    group. Losses and the aux loss within 1e-6 relative, every leaf within
    1e-6 of its norm (the router's gradient, a partial over the group, is
    summed once), every dispatch decision of every layer, forward and
    recomputation, equal to the whole run's on the same microbatches."""
    _check(run_22, arch)
    for res in run_22:
        assert len(res[arch]["dispatch"]) == 3 and all(res[arch]["dispatch"]), res[arch]["dispatch"]
        router = [leaf for leaf in res[arch]["leaves"] if leaf["name"].endswith("moe.router")]
        assert len(router) == 2 and all(leaf["moved"] > 100 * LEAF_TOL * leaf["norm"] for leaf in router)


@pytest.mark.parametrize("arch", MOE)
def test_moe_reduce_scatter_gives_the_same_bits(arch, run_22):
    for res in run_22:
        base, rs = res[arch], res[arch + "_rs"]
        assert rs["digest"] == base["digest"] and rs["got"] == base["got"]
        assert rs["received"] < base["received"]


def test_a_model_group_without_rows_replays(run_22):
    _check(run_22, "idle")


def test_an_moe_model_group_without_rows_replays(run_22):
    """arctic smoke with one model group computing two microbatches: the
    other's ranks run the meta pass once and replay (no routing of theirs
    is real); the computing group's dispatch is the whole run's."""
    _check(run_22, "moe_idle")
    assert [all(res["moe_idle"]["dispatch"]) for res in run_22] == [True, True, False, False]
    assert all(len(res["moe_idle"]["dispatch"]) == 2 for res in run_22[:2])


def test_vision_projector_is_summed_once_over_each_group(run_12):
    """internvl2's projector runs on each rank's block of the sequence: its
    gradient is a partial over the group, summed once. Its leaves moved far
    more than the tolerance, so a double sum over ``model`` would fail."""
    results, _, _ = run_12
    _check(results, "vision")
    for res in results:
        proj = [leaf for leaf in res["vision"]["leaves"] if leaf["name"].startswith("vision_proj")]
        norms = [leaf for leaf in res["vision"]["leaves"] if "norm" in leaf["name"]]
        assert len(proj) == 2 and norms
        for leaf in proj + norms:
            assert leaf["moved"] > 100 * LEAF_TOL * leaf["norm"], leaf


def test_split_layer_matches_jax(run_12):
    _, tmp, layer = run_12
    cfg = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    x = jnp.asarray(layer["x"])
    params = {k: jnp.asarray(v) for k, v in layer.items()}
    pos = jnp.arange(x.shape[1])[None, :]
    want_attn, _ = jattention.apply({k: params[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}, x, cfg,
                                    positions=pos)
    want_mlp = jmlp.apply({k: params[k] for k in ("w_gate", "w_up", "w_down")}, x)
    for r in range(2):
        got = np.load(tmp / f"layer_{r}.npz")
        assert int(got["heads"]) == 2 and int(got["hidden"]) == cfg.d_ff // 2  # the rank's share
        np.testing.assert_allclose(got["attn"], np.asarray(want_attn), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["mlp"], np.asarray(want_mlp), rtol=1e-5, atol=1e-5)


def test_vocab_parallel_loss_matches_jax(run_12):
    results, _, _ = run_12
    cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, bridge.params_to_numpy(LanguageModel(cfg).init(0, device="cpu"), cfg))
    jcfg = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2, SEQ)).astype(np.int32)[0]
    total, m = jax_lm_loss(JaxModel(jcfg), params, {"tokens": jnp.asarray(tokens)}, z_loss=1e-4)
    for res in results:
        assert res["loss"]["total"] == pytest.approx(float(total), rel=1e-6)
        assert res["loss"]["loss"] == pytest.approx(float(m["loss"]), rel=1e-6)


def test_recorded_collectives_equal_a_gloo_runs_bytes(run_22):
    """Rank 0's received bytes in one tensor-parallel step on (2, 2) (two
    model groups of 4 rows x 8 tokens) are what the dry run records, by
    type; under ``tp_reduce_scatter`` the boundaries reduce-scatter and
    the total falls."""
    cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    counted = {}
    for name, rs in (("bytes", False), ("bytes_rs", True)):
        summary = dryrun.count_combo(cfg.replace(tp_reduce_scatter=rs), InputShape("t", SEQ, 8, "train"), mesh,
                                     tensor_parallel=True)
        coll = summary["collectives"]
        assert coll["total_bytes"] == run_22[0][name]["received"] > 0
        assert summary["work"] == dict(summary["work"], rows_per_microbatch=4, computing_ranks=4,
                                       tensor_parallel=True)
        counted[name] = coll["by_type_bytes"]
    assert set(counted["bytes"]) == {"all-gather", "all-reduce", "all-to-all"}
    assert set(counted["bytes_rs"]) == {"all-gather", "all-reduce", "all-to-all", "reduce-scatter"}
    assert sum(counted["bytes_rs"].values()) < sum(counted["bytes"].values())


def test_moe_recorded_collectives_equal_a_gloo_runs_bytes(run_22):
    """The same for arctic smoke (its aux loss's sum over the group, its
    experts and residual MLP split): rank 0's received bytes in one step
    are what the dry run records."""
    cfg = get_config("arctic-480b", "smoke").replace(compute_dtype="float32")
    summary = dryrun.count_combo(cfg, InputShape("t", MOE_SEQ, 8, "train"), make_host_mesh(2, 2, devices=["meta"] * 4),
                                 tensor_parallel=True)
    assert summary["collectives"]["total_bytes"] == run_22[0]["moe_bytes"]["received"] > 0


def _gns_bounds(calls, ema):
    """Each logged noise scale's allowed difference when each of its
    squares may differ by ``SQ_RTOL`` of itself: ``calls`` are the
    one-process run's ``GradientNoiseScale.update`` arguments (E||g_small||^2,
    ||g_big||^2, b_small, b_big), one an update. tr(Sigma) and |G|^2 are
    linear in the squares, so their terms' bounds add; the EMA carries them
    with its weights; B = tr / |G|^2 moves by their relative bounds' sum
    (first order)."""
    out, tr = [], None
    for small, big, bs, bb in calls:
        k = 1.0 / bs - 1.0 / bb
        t, g = (small - big) / k, (bb * big - bs * small) / (bb - bs)
        et = SQ_RTOL * (abs(small) + abs(big)) / abs(k)
        eg = SQ_RTOL * (bb * abs(big) + bs * abs(small)) / (bb - bs)
        if tr is None:
            tr, gs, dtr, dg = t, g, et, eg
        else:
            tr, gs = ema * tr + (1 - ema) * t, ema * gs + (1 - ema) * g
            dtr, dg = ema * dtr + (1 - ema) * et, ema * dg + (1 - ema) * eg
        out.append(abs(tr / gs) * (dtr / abs(tr) + dg / abs(gs)))
    return out


def test_sebs_trainer_on_a_mesh_splits_over_model_groups(monkeypatch):
    """``SEBSTrainer(mesh=(1, 2), tensor_parallel=True)`` on qwen2.5-3b smoke
    (f32, momentum, SEBS b1 4, C1 12, rho 2, 2 stages, microbatch 2: 6
    updates) against the same schedule in one process: every loss within
    1e-6 relative, every param within 1e-6 of its leaf's norm, the ladder
    the same. The noise-scale log within what ``SQ_RTOL`` on the squares
    it takes (``grad_sq_small``, ``grad_sq_big``: the spawned cases hold
    them there) carries through the estimator (:func:`_gns_bounds`, from
    the squares the one-process run logs to ``GradientNoiseScale``; the
    mesh run's estimator runs in its workers): it
    is a ratio of differences ~10^2 times smaller than their terms, so it
    multiplies the squares' differences (2.8e-3 to 3.0e-3 relative; the
    split run has come out 1.7e-5 to 1.4e-4 from the one-process run)."""
    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.core.noise_scale import GradientNoiseScale
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves

    calls = []
    update = GradientNoiseScale.update

    def recorded(self, sum_sq_small, sq_big, b_small, b_big):
        calls.append((sum_sq_small, sq_big, b_small, b_big))
        return update(self, sum_sq_small, sq_big, b_small, b_big)

    monkeypatch.setattr(GradientNoiseScale, "update", recorded)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
        model = LanguageModel(cfg)
        runs = {}
        for mesh in (None, make_host_mesh(1, 2, devices=["cpu"] * 2)):
            opt = make_optimizer("momentum", beta=0.9)
            pipe = DataPipeline(TokenDataset(cfg.vocab_size, SEQ, 0), "cpu" if mesh is None else mesh)
            kw = {"mesh": mesh, "param_axes": model.param_axes(), "deadline": 300.0,
                  "tensor_parallel": True} if mesh is not None else {}
            trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=12, rho=2.0, num_stages=2, eta=0.5), pipe,
                                  microbatch=2, grad_clip=1.0, **kw)
            params = model.init(0, device="cpu")
            calls.clear()
            state, log = trainer.run(TrainState(params, opt.init(params), 0), log_every=1)
            runs[mesh is not None] = (log, [t.detach() for t in tree_leaves(state.params)], list(calls))
    finally:
        torch.set_num_threads(old)
    (ref, ref_params, ref_sq), (log, params, _) = runs[False], runs[True]
    assert len(log.losses) == 6 and log.stages == ref.stages and log.batch_sizes == ref.batch_sizes
    for a, b in zip(log.losses, ref.losses, strict=True):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (log.losses, ref.losses)
    assert len(ref_sq) == len(ref.noise_scales)  # every update accumulates: one estimate each
    bounds = _gns_bounds(ref_sq, GradientNoiseScale().ema)
    for a, b, bound in zip(log.noise_scales, ref.noise_scales, bounds, strict=True):
        assert abs(a - b) <= bound, (log.noise_scales, ref.noise_scales, bounds)
    for a, b in zip(params, ref_params, strict=True):
        assert float((a - b).abs().max()) <= LEAF_TOL * float(b.norm())


def _unsharded_greedy(model, params, tokens, rows, new):
    out = []
    with torch.no_grad():
        for r0 in range(0, tokens.shape[0], rows):
            cache = model.init_cache(rows, tokens.shape[1] + new, dtype=torch.float32, device="cpu")
            logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[r0:r0 + rows])}, cache)
            steps = [logits]
            for t in range(new - 1):
                nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                index = torch.full((rows,), tokens.shape[1] + t, dtype=torch.int32)
                logits, cache = model.decode_step(params, nxt, cache, index)
                steps.append(logits)
            out.append(steps)
    return [torch.cat([s[i] for s in out]) for i in range(new)]


def test_serving_on_a_mesh_gives_the_engines_greedy_tokens():
    """Prefill and 3 greedy decode steps on (2, 2) with the model groups
    splitting qwen2.5-3b smoke (2 query heads and 1 kv head a rank), with 6
    heads (every head on every rank), gemma2-9b smoke (soft caps, sliding
    windows) and the MoE family's smoke (2 of 4 experts a rank, routing the
    whole prompt; a decode step's one position padded to the group; arctic's
    residual MLP split): the tokens equal the single-process engine's calls
    on the same rows, the logits within 1e-5 of their scale."""
    from repro_torch.distributed.mesh_serve import serve_on_mesh

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for arch, over in (("qwen2.5-3b", {}), ("qwen2.5-3b", {"num_heads": 6}), ("gemma2-9b", {}),
                           ("dbrx-132b", {}), ("arctic-480b", {})):
            cfg = get_config(arch, "smoke").replace(compute_dtype="float32", **over)
            model = LanguageModel(cfg)
            tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 11)).astype(np.int32)
            runs.append((model, model.init(0, device="cpu"), tokens))
        got = serve_on_mesh(make_host_mesh(2, 2, devices=["cpu"] * 4), runs, 4, tensor_parallel=True)
        want = [_unsharded_greedy(model, params, tokens, 2, 4) for model, params, tokens in runs]
    finally:
        torch.set_num_threads(old)
    for steps, ref in zip(got, want, strict=True):
        for a, b in zip(steps, ref, strict=True):
            assert torch.equal(a[:, -1].argmax(-1), b[:, -1].argmax(-1))
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_uncovered_families_are_refused_with_their_roadmap_item(arch):
    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.distributed.sharded import tensor_parallel
    from repro_torch.optim import make_optimizer

    cfg = get_config(arch, "smoke")
    model = LanguageModel(cfg)
    mesh = make_host_mesh(1, 2, devices=["meta"] * 2)
    match = "ROADMAP.md Queue 1 item 6[abc]"
    with pytest.raises(ValueError, match=match):
        SEBSTrainer(model, make_optimizer("psgd"), SEBS(b1=2, C1=4, rho=2.0, num_stages=1, eta=0.5),
                    DataPipeline(TokenDataset(cfg.vocab_size, 8, 0), "cpu"), mesh=mesh,
                    param_axes=model.param_axes(), tensor_parallel=True)
    with pytest.raises(ValueError, match=match):
        tensor_parallel(model, model.abstract_init(), mesh)
    if not cfg.is_encoder_decoder:
        with pytest.raises(ValueError, match=match):
            dryrun.count_combo(cfg, InputShape("t", 8, 2, "train"), mesh, tensor_parallel=True)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_full_width_dry_run_puts_every_rank_to_work(shape):
    """qwen2.5-3b on (16, 16): the model groups share their rows, so all 256
    ranks compute (16 rows a rank of train_4k's 256, where the data-parallel
    step gives one row to each; 2 of prefill_32k's 32, where 32 ranks
    compute), each under 12 GB."""
    summary = dryrun.run_combo("qwen2.5-3b", shape, False, tensor_parallel=True)
    work = summary["work"]
    assert work["computing_ranks"] == 256 and work["tensor_parallel"]
    assert work["rows_per_microbatch"] == {"train_4k": 16, "prefill_32k": 2}[shape]
    assert summary["memory"]["peak_bytes_per_device"] < 12e9
    if shape == "train_4k":
        assert summary["cost"]["kernels"]["flash_attention_bwd"]["calls"] == 36
