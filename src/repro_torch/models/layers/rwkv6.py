"""RWKV6 "Finch" mixers [arXiv:2404.05892]: time-mix (attention-free token
mixer with data-dependent per-channel decay) and channel-mix (the RWKV FFN).

Time-mix per head h (head_dim = cfg.rwkv_head_dim):
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    y_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
with w_t = exp(-exp(w_base + LoRA(x̄_t))) data-dependent (the Finch change
vs RWKV5), realized through the shared gated-linear-attention recurrence
(``linear_attention``: the chunked GLA kernels over a sequence, a plain step
in decode). Token-shift ("x̄") states make decode O(1): the cache stores the
previous token's activations plus the (H, K, V) wkv state.

The JAX package's names, shapes, scales and dtypes (the decay path in f32);
its sharding constraints are left out.

Under tensor parallelism (a ``"tp"`` entry in the params: the sharded
step's group over the mesh's ``model`` group, ``distributed/sharded.py``)
each mixer takes the rank's block of the sequence, gathers the sequence
(the token shift needs the token before the block) and splits its work as
GSPMD splits the JAX package's under its constraints. The time mix runs
the rank's H/M heads: ``w_r``, ``w_k``, ``w_v`` and ``w_g`` arrive as
their columns, ``bonus_u`` as its heads and ``w_o`` as its rows; the
leaves that carry ``embed`` but are read by head (``decay_base``,
``ln_scale``, ``decay_lora_b``'s columns) arrive whole and the rank slices
its heads' part; the group norm is per head, so nothing crosses the group
before ``w_o``, whose partial product is summed onto the rank's block. The
channel mix splits its hidden dimension (``w_k``'s columns, ``w_v``'s
rows): ``kv`` is summed onto the rank's block before the receptance, whole
``w_r`` on that block, multiplies it. The cache's ``wkv`` holds the rank's
heads; its token shifts stay whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.linear_attention import gla_scan, gla_step

DECAY_LORA = 64


def _dims(cfg):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_time_mix(gen: torch.Generator, cfg, device="cuda"):
    d = cfg.d_model
    nh, hd = _dims(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    s = d**-0.5

    def normal(shape, scale, dt=dtype):
        return torch.randn(shape, generator=gen, dtype=dt, device=device) * scale

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "mu_r": full((d,), 0.5),
        "mu_k": full((d,), 0.5),
        "mu_v": full((d,), 0.5),
        "mu_w": full((d,), 0.5),
        "mu_g": full((d,), 0.5),
        "w_r": normal((d, d), s),
        "w_k": normal((d, d), s),
        "w_v": normal((d, d), s),
        "w_g": normal((d, d), s),
        "w_o": normal((d, d), s),
        "decay_base": full((d,), -6.0, torch.float32),
        "decay_lora_a": normal((d, DECAY_LORA), s, torch.float32),
        "decay_lora_b": normal((DECAY_LORA, d), DECAY_LORA**-0.5, torch.float32),
        "bonus_u": full((nh, hd), 0.0, torch.float32),
        "ln_scale": full((d,), 0.0),  # per-head group-norm scale
    }


def time_mix_axes(cfg):
    """The logical axes of :func:`init_time_mix`'s leaves."""
    return {
        **{f"mu_{n}": ("embed",) for n in "rkvwg"},
        **{f"w_{n}": ("embed", "heads") for n in "rkvg"},
        "w_o": ("heads", "embed"),
        "decay_base": ("embed",),
        "decay_lora_a": ("embed", None),
        "decay_lora_b": (None, "embed"),
        "bonus_u": ("ssm_heads", None),
        "ln_scale": ("embed",),
    }


def init_channel_mix(gen: torch.Generator, cfg, device="cuda"):
    d, dff = cfg.d_model, cfg.d_ff
    dtype = getattr(torch, cfg.param_dtype)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale

    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "w_k": normal((d, dff), d**-0.5),
        "w_v": normal((dff, d), dff**-0.5),
        "w_r": normal((d, d), d**-0.5),
    }


def channel_mix_axes(cfg):
    """The logical axes of :func:`init_channel_mix`'s leaves."""
    return {"mu_k": ("embed",), "mu_r": ("embed",), "w_k": ("embed", "mlp"), "w_v": ("mlp", "embed"),
            "w_r": ("embed", "heads")}


def init_cache(cfg, batch: int, dtype, device="cuda"):
    nh, hd = _dims(cfg)
    d = cfg.d_model
    return {
        "wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),  # prev token (time-mix)
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),  # prev token (channel-mix)
    }


CACHE_AXES = {
    "wkv": ("batch", "ssm_heads", None, None),
    "shift_t": ("batch", "embed"),
    "shift_c": ("batch", "embed"),
}


def _token_shift(x, prev):
    """x: (B, S, d); prev: (B, d) previous token (or zeros). Returns x_{t-1}."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def apply_time_mix(params, x, cfg, *, cache=None, decode: bool = False):
    """Returns (y, new_wkv_state, new_shift). x: (B, S, d); under tensor
    parallelism (``params["tp"]``) the rank's block of the sequence, and so
    is y (see the module)."""
    tp = params.get("tp")
    if tp is None:
        return _time_mix(params, x, cfg, cache, decode, slice(None))
    nh, hd = _dims(cfg)
    c = nh // tp.width * hd  # the rank's channels: its heads'
    y, state, shift = _time_mix(params, tp.gather(x), cfg, cache, decode, slice(tp.me * c, (tp.me + 1) * c))
    return tp.scatter(y), state, shift


def _time_mix(params, x, cfg, cache, decode: bool, mine: slice):
    """The time mix over the whole sequence x, on the heads whose channels
    ``mine`` names (every channel, or a rank's: its projections arrive as
    those columns and rows, the per-channel leaves whole). Returns (y, the
    heads' wkv state, the shift); y is a partial sum over the heads where
    they are a rank's."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    dtype = x.dtype
    prev = cache["shift_t"] if cache is not None else torch.zeros((b, d), dtype=dtype, device=x.device)
    x_prev = _token_shift(x, prev)

    xr = _lerp(x, x_prev, params["mu_r"])
    xk = _lerp(x, x_prev, params["mu_k"])
    xv = _lerp(x, x_prev, params["mu_v"])
    xw = _lerp(x, x_prev, params["mu_w"])
    xg = _lerp(x, x_prev, params["mu_g"])

    r = xr @ params["w_r"].to(dtype)
    k = xk @ params["w_k"].to(dtype)
    v = xv @ params["w_v"].to(dtype)
    g = xg @ params["w_g"].to(dtype)
    nh = r.shape[-1] // hd
    # data-dependent decay (Finch): w = exp(-exp(base + lora))
    lora = (torch.tanh(xw.float()) @ params["decay_lora_a"]) @ params["decay_lora_b"][:, mine]
    log_w = -torch.exp(params["decay_base"][mine] + lora)  # (B, S, channels), < 0

    r = r.reshape(b, s, nh, hd)
    kh = k.reshape(b, s, nh, hd)
    vh = v.reshape(b, s, nh, hd)
    lwh = log_w.reshape(b, s, nh, hd)

    if decode:
        y1, new_state = gla_step(
            cache["wkv"], r[:, 0], kh[:, 0], vh[:, 0], lwh[:, 0],
            bonus_u=params["bonus_u"], include_current=False,
        )
        y = y1[:, None]
    else:
        y, new_state = gla_scan(
            r, kh, vh, lwh, bonus_u=params["bonus_u"], include_current=False,
            initial_state=None if cache is None else cache["wkv"],
        )
    new_shift = x[:, -1, :]

    # per-head group norm, then gate and output projection
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    yn = yf * (var + cfg.norm_eps) ** -0.5
    yn = yn.reshape(b, s, nh * hd) * (1.0 + params["ln_scale"][mine].float())
    yn = (yn * F.silu(g.float())).to(dtype)
    return yn @ params["w_o"].to(dtype), new_state, new_shift


def apply_channel_mix(params, x, cfg, *, cache=None):
    """Returns (y, new_shift). Under tensor parallelism x and y are the
    rank's block of the sequence (see the module)."""
    tp = params.get("tp")
    xs = x if tp is None else tp.gather(x)
    b, s, d = xs.shape
    dtype = xs.dtype
    prev = cache["shift_c"] if cache is not None else torch.zeros((b, d), dtype=dtype, device=xs.device)
    x_prev = _token_shift(xs, prev)
    xk = _lerp(xs, x_prev, params["mu_k"])
    xr = _lerp(xs, x_prev, params["mu_r"])
    k = torch.square(F.relu(xk @ params["w_k"].to(dtype)))
    kv = k @ params["w_v"].to(dtype)
    if tp is not None:  # kv summed onto the rank's block, where the receptance multiplies it
        kv, xr = tp.scatter(kv), tp.slice(xr)
    r = torch.sigmoid((xr @ params["w_r"].to(dtype)).float())
    return (r * kv.float()).to(dtype), xs[:, -1, :]
