"""Tensor parallelism over the mesh's ``model`` groups for the recurrent
families (``repro_torch/distributed/sharded.py``'s ``TensorParallel``), on
the CPU: rwkv6's heads and channel-mix hidden dimension, Mamba2's heads and
zamba2's shared block split over each ``model`` group, as the JAX package's
GSPMD splits them under its rules.

- one spawn of four gloo workers on (2, 2) runs every case
  (``tests/_torch_tp_cases.py``): rwkv6 and zamba2 smoke (f32) through the
  sharded step, two model groups of 2 ranks, against the elastic step's
  whole run on one worker over the same microbatches, 6 momentum updates,
  each started from the whole run's state: losses within 1e-6 relative,
  ``grad_sq_small``, ``grad_sq_big`` and the norm within 1e-5 at every
  update, every param leaf within 1e-6 of its norm after the last.
  (rwkv6 smoke magnifies rounding along its trajectory: its one-process
  run summed over its microbatches in another order differs from itself by
  1.5e-2 in ``grad_sq_big`` after 5 updates, so two runs are compared
  update by update from one state.) ``tp_reduce_scatter`` gives the same
  bits with fewer bytes received; the dry run's recorded collectives of a
  step equal a gloo run's received bytes;
- the split time mix, channel mix and Mamba2 layer (over a sequence from a
  cache, then one decode step from the cache they leave) against the JAX
  package's ``apply_time_mix``, ``apply_channel_mix`` and ``mamba2.apply``
  at f32 within 1e-5, the ranks' caches against JAX's;
- ``serve_on_mesh(..., tensor_parallel=True)`` of both against the
  single-process engine's greedy calls;
- the split dimensions (Mamba2's packed leaves and rwkv6's channel-mix
  receptance whole), the refusals where the ``model`` axis does not divide
  the heads, and the full-width prefill_32k dry run on (16, 16) on every
  rank.

~45-60 s on one worker (two spawns of four gloo workers, the dry runs at
full width ~5 s each).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_tp_cases import tp_worker  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.layers import mamba2 as jmamba2  # noqa: E402
from repro.models.layers import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.layers import mamba2, rwkv6  # noqa: E402

LOSS_RTOL = 1e-6
SQ_RTOL = 1e-5
LEAF_TOL = 1e-6
LAYER_TOL = 1e-5
ARCHS = {"rwkv6-1.6b": 8, "zamba2-2.7b": 9}  # arch -> positions (zamba2's carry padded to 10)


def _train(name, arch, updates=6, rows=2, rs=False, resync=True):
    return (name, "train", {"arch": arch, "overrides": {}, "width": 2, "local_accum": 1, "updates": updates,
                            "reduce_scatter": rs, "seq": ARCHS[arch], "rows": rows, "resync": resync})


def _layer_inputs(tmp):
    """Each layer's params from the port's init, every leaf moved off its
    initial value (non-zero bonus, decay spread, scales, biases), the input
    and the caches the sequence starts from, from a seeded numpy stream."""
    rng = np.random.default_rng(30)
    gen = torch.Generator().manual_seed(30)
    rcfg, zcfg = get_config("rwkv6-1.6b", "smoke"), get_config("zamba2-2.7b", "smoke")
    layers = {"tmix": rwkv6.init_time_mix(gen, rcfg, "cpu"), "cmix": rwkv6.init_channel_mix(gen, rcfg, "cpu"),
              "mamba": mamba2.init(gen, zcfg, "cpu")}
    data = {}
    for key, params in layers.items():
        for name, t in params.items():
            a = t.float().numpy()
            data[f"{key}.{name}"] = (a + rng.standard_normal(a.shape) * 0.1 * (a.std() or 1.0)).astype(np.float32)
    b, s, d = 2, 11, rcfg.d_model
    nh, hd = d // rcfg.rwkv_head_dim, rcfg.rwkv_head_dim
    d_in = zcfg.ssm_expand * zcfg.d_model
    data.update(x=rng.standard_normal((b, s, d)), x1=rng.standard_normal((b, 1, d)),
                wkv=rng.standard_normal((b, nh, hd, hd)) * 0.1, shift_t=rng.standard_normal((b, d)),
                shift_c=rng.standard_normal((b, d)),
                ssm=rng.standard_normal((b, d_in // zcfg.ssm_head_dim, zcfg.ssm_state, zcfg.ssm_head_dim)) * 0.1,
                conv=rng.standard_normal((b, zcfg.ssm_conv_width - 1, d_in + 2 * zcfg.ssm_state)))
    data = {k: np.asarray(v, np.float32) for k, v in data.items()}
    np.savez(tmp / "recurrent.npz", **data)
    return data


@pytest.fixture(scope="module")
def run_22(tmp_path_factory):
    """(2, 2) through the host slots: every case of the file in one spawn."""
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    data = _layer_inputs(tmp)
    cases = [("recurrent", "recurrent", {})]
    for arch in ARCHS:
        cases += [_train(arch, arch), _train(arch + "_rs", arch, rs=True),
                  _train(arch + "_bytes", arch, updates=1, rows=4, resync=False)]
    torch.multiprocessing.spawn(tp_worker, args=(4, str(tmp), (2, 2), cases, False), nprocs=4, join=True)
    results = [json.loads((tmp / f"result_{r}").read_text()) for r in range(4)]
    layers = [dict(np.load(tmp / f"recurrent_{r}.npz")) for r in range(4)]
    return results, layers, data


@pytest.mark.parametrize("arch", list(ARCHS))
def test_recurrent_run_holds_the_unsharded_run(arch, run_22):
    """Every update's metrics from the whole run's state, and the last
    update's leaves; the split leaves (rwkv6's bonus, Mamba2's per-head
    leaves and output projection) and the packed ones that run whole
    (Mamba2's in_proj and conv, rwkv6's channel-mix receptance, whose
    gradients are partials over each group) moved more than 4 times the
    tolerance, so a missing or doubled sum over ``model``, which would move
    them by about as much again, would fail."""
    results, _, _ = run_22
    for r, res in enumerate(results):
        run = res[arch]
        assert len(run["got"]) == len(run["want"]) == 6
        for got, want in zip(run["got"], run["want"], strict=True):
            for k, tol in (("loss", LOSS_RTOL), ("grad_sq_small", SQ_RTOL), ("grad_sq_big", SQ_RTOL),
                           ("grad_norm", SQ_RTOL)):
                assert abs(got[k] - want[k]) <= tol * abs(want[k]), (arch, r, k, got[k], want[k])
        for leaf in run["leaves"]:
            assert leaf["diff"] <= LEAF_TOL * leaf["norm"], (arch, r, leaf)
        keys = ("tmix.bonus_u", "tmix.w_o", "tmix.ln_scale", "cmix.w_r") if arch == "rwkv6-1.6b" else \
            ("mamba.in_proj", "mamba.conv_w", "mamba.dt_bias", "mamba.out_proj")
        for key in keys:
            moved = [leaf for leaf in run["leaves"] if leaf["name"].endswith(key)]
            assert moved and all(leaf["moved"] > 4 * LEAF_TOL * leaf["norm"] for leaf in moved), (key, moved)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_recurrent_reduce_scatter_gives_the_same_bits(arch, run_22):
    for res in run_22[0]:
        base, rs = res[arch], res[arch + "_rs"]
        assert rs["digest"] == base["digest"] and rs["got"] == base["got"]
        assert rs["received"] < base["received"]


def _jax_layers(data):
    """The JAX package's layers on the file's params, input and caches:
    each output, and the caches after the sequence and after the decode step."""
    p = {k: jnp.asarray(v) for k, v in data.items()}
    rcfg = jax_config("rwkv6-1.6b", "smoke").replace(compute_dtype="float32")
    zcfg = jax_config("zamba2-2.7b", "smoke").replace(compute_dtype="float32")
    tmix = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("tmix.")}
    cmix = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("cmix.")}
    mamba = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("mamba.")}
    cache = {"wkv": p["wkv"], "shift_t": p["shift_t"], "shift_c": p["shift_c"]}
    out = {}
    y, wkv, shift = jrwkv6.apply_time_mix(tmix, p["x"], rcfg, cache=cache)
    y1, wkv1, _ = jrwkv6.apply_time_mix(tmix, p["x1"], rcfg, cache=dict(cache, wkv=wkv, shift_t=shift), decode=True)
    yc, shift_c = jrwkv6.apply_channel_mix(cmix, p["x"], rcfg, cache=cache)
    out.update(tmix=y, tmix_decode=y1, wkv=wkv, wkv_decode=wkv1, cmix=yc, cmix_shift=shift_c)
    s = p["x"].shape[1]
    ym, mc = jmamba2.apply(mamba, p["x"], zcfg, cache={"ssm": p["ssm"], "conv": p["conv"]})
    ym1, mc1 = jmamba2.apply(mamba, p["x1"], zcfg, cache=mc, cache_index=jnp.full((p["x"].shape[0],), s, jnp.int32))
    out.update(mamba=ym, mamba_decode=ym1, ssm=mc["ssm"], conv=mc["conv"], ssm_decode=mc1["ssm"],
               conv_decode=mc1["conv"])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("layer", ["tmix", "cmix", "mamba"])
def test_split_recurrent_layer_matches_jax(layer, run_22):
    """Each rank's gathered output of the split layer against JAX's, and
    the ranks' caches (the heads of the ``wkv`` and ``ssm`` states, Mamba2's
    conv window of each rank's x channels and all of B and C) against
    JAX's, after the sequence and after the decode step; every rank of a
    model group gets the same output."""
    _, layers, data = run_22
    want = _jax_layers(data)
    outputs = {"tmix": ("tmix", "tmix_decode"), "cmix": ("cmix", "cmix_shift"),
               "mamba": ("mamba", "mamba_decode")}[layer]
    for got in layers:
        for key in outputs:
            np.testing.assert_allclose(got[key], want[key], rtol=LAYER_TOL, atol=LAYER_TOL, err_msg=key)
    if layer == "cmix":
        return
    cfg = get_config("zamba2-2.7b", "smoke")
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    for group in (layers[:2], layers[2:]):  # the model groups: ranks (0, 1) and (2, 3)
        for key in (("wkv", "wkv_decode") if layer == "tmix" else ("ssm", "ssm_decode")):
            np.testing.assert_allclose(np.concatenate([g[key] for g in group], axis=1), want[key],
                                       rtol=LAYER_TOL, atol=LAYER_TOL, err_msg=key)
        if layer == "mamba":
            for key in ("conv", "conv_decode"):
                c = d_in // len(group)
                for me, g in enumerate(group):
                    mine = np.concatenate([want[key][..., me * c:(me + 1) * c], want[key][..., d_in:d_in + 2 * n]],
                                          axis=-1)
                    np.testing.assert_allclose(g[key], mine, rtol=LAYER_TOL, atol=LAYER_TOL, err_msg=key)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_recurrent_recorded_collectives_equal_a_gloo_runs_bytes(arch, run_22):
    """Rank 0's received bytes in one tensor-parallel step on (2, 2) (two
    model groups of 4 rows) are what the dry run records: the boundaries,
    the packed leaves' partial gradients summed over the group, Mamba2's
    norm's sums of squares."""
    cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
    summary = dryrun.count_combo(cfg, InputShape("t", ARCHS[arch], 8, "train"),
                                 make_host_mesh(2, 2, devices=["meta"] * 4), tensor_parallel=True)
    assert summary["collectives"]["total_bytes"] == run_22[0][0][arch + "_bytes"]["received"] > 0
    assert summary["work"]["computing_ranks"] == 4 and summary["work"]["tensor_parallel"]


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


def test_serving_recurrent_models_on_a_mesh_gives_the_engines_greedy_tokens():
    """Prefill and 3 greedy decode steps on (2, 2), rwkv6 and zamba2 smoke
    (f32) split over the model groups (a rank: 2 of 4 rwkv heads, 4 of 8
    Mamba2 heads, 2 of the shared block's 4 attention heads; its cache the
    heads' state): the tokens equal the single-process engine's calls on
    the same rows, the logits within 1e-5 of their scale."""
    from repro_torch.distributed.mesh_serve import serve_on_mesh

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for arch in ARCHS:
            cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
            model = LanguageModel(cfg)
            tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 11)).astype(np.int32)
            runs.append((model, model.init(0, device="cpu"), tokens))
        got = serve_on_mesh(make_host_mesh(2, 2, devices=["cpu"] * 4), runs, 4, tensor_parallel=True)
        want = [_unsharded_greedy(model, params, tokens, 2, 4) for model, params, tokens in runs]
    finally:
        torch.set_num_threads(old)
    for steps, ref in zip(got, want, strict=True):
        for a, b in zip(steps, ref, strict=True):
            assert torch.equal(a[:, -1].argmax(-1), b[:, -1].argmax(-1))
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_packed_leaves_run_whole_and_the_heads_split():
    """On (2, 2): Mamba2's in_proj, conv_w and conv_b and rwkv6's
    channel-mix receptance run whole (though the rules split their storage
    over ``model``); the heads' leaves split by heads."""
    from repro_torch.distributed.sharded import tensor_parallel
    from repro_torch.sharding.partitioning import axes_leaves, axes_paths
    from repro_torch.train.state import unstack_axes

    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    want = {("mamba", "in_proj"): None, ("mamba", "conv_w"): None, ("mamba", "conv_b"): None,
            ("mamba", "out_proj"): 0, ("mamba", "norm_scale"): 0, ("mamba", "dt_bias"): 0, ("mamba", "A_log"): 0,
            ("mamba", "D"): 0, ("cmix", "w_r"): None, ("cmix", "w_k"): 1, ("cmix", "w_v"): 0, ("tmix", "w_r"): 1,
            ("tmix", "w_o"): 0, ("tmix", "bonus_u"): 0, ("tmix", "decay_lora_b"): None, ("tmix", "ln_scale"): None,
            ("attn", "wq"): 1, ("mlp", "w_up"): 1}
    seen = set()
    for arch in ARCHS:
        model = LanguageModel(get_config(arch, "smoke"))
        params = model.abstract_init()
        dims = tensor_parallel(model, params, mesh).dims
        axes = unstack_axes(model.param_axes(), params)
        for path, dim in zip(axes_paths(axes), dims, strict=True):
            if tuple(path[-2:]) in want:
                assert dim == want[tuple(path[-2:])], (arch, path, dim)
                seen.add(tuple(path[-2:]))
    assert seen == set(want)


@pytest.mark.parametrize("arch,model_axis,dimension", [("rwkv6-1.6b", 8, "rwkv heads"),
                                                       ("zamba2-2.7b", 16, "Mamba2 heads")])
def test_a_model_axis_that_does_not_divide_the_heads_is_refused(arch, model_axis, dimension):
    from repro_torch.distributed.sharded import tensor_parallel

    model = LanguageModel(get_config(arch, "smoke"))
    mesh = make_host_mesh(1, model_axis, devices=["meta"] * model_axis)
    with pytest.raises(ValueError, match=dimension):
        tensor_parallel(model, model.abstract_init(), mesh)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_full_width_prefill_puts_every_rank_to_work(arch):
    """prefill_32k on (16, 16): the model groups share their rows, so all
    256 ranks compute (2 rows a model group), where the data-parallel
    forward gives its 32 rows to 32 ranks."""
    summary = dryrun.run_combo(arch, "prefill_32k", False, tensor_parallel=True)
    work = summary["work"]
    assert work["computing_ranks"] == 256 and work["tensor_parallel"] and work["rows_per_microbatch"] == 2
    assert dryrun.run_combo(arch, "prefill_32k", False)["work"]["computing_ranks"] == 32
