"""Mamba2 (SSD) mixer [arXiv:2405.21060], as used by zamba2-2.7b.

Structure: in_proj → (x, z, B, C, dt); a short causal depthwise conv over
(x, B, C); the selective state-space recurrence with a per-head scalar
decay ``a_t = exp(dt_t * A)``, realized through the shared gated-linear-
attention recurrence (``linear_attention``: the chunked GLA kernels with
the current token included over a sequence, a plain step in decode); the
gated output ``y * silu(z)``; out_proj.

The recurrence maps onto GLA with q = C and k = B shared by every head,
v = dt * x and the head's log decay dt * A on every k channel. The kernels
take contiguous (B, S, H, K) operands, so the broadcasts over heads (q, k)
and over K (the decay) are materialized; autograd sums their gradients
back into C, B and dt.

Decode keeps two cache entries per layer: the SSM state (B, H, state, hd)
f32 and the rolling conv window (B, conv_w - 1, conv_channels). The conv is
one f32 function (:func:`_causal_conv`) in prefill and decode alike, a
fixed-order sum over the window, so a token gives bit-identical
activations whether it arrives in a chunk or in a decode tick: the paged
engine feeds a prompt's tail through decode ticks and relies on that.

The JAX package's names, shapes, scales and dtypes (``A_log`` and ``D`` in
f32); its sharding constraints are left out.

Under tensor parallelism (a ``"tp"`` entry in the params: the sharded
step's group over the mesh's ``model`` group, ``distributed/sharded.py``)
the layer takes the rank's block of the sequence, gathers the sequence and
runs the rank's H/M heads, as GSPMD splits the JAX package's ``ssm_inner``
and ``ssm_heads``. The packed leaves (``in_proj``'s x | z | B | C | dt
columns, the conv's x | B | C channels) arrive whole, and the rank takes
its heads' x, z and dt and all of B and C; ``out_proj``'s rows,
``norm_scale``, ``dt_bias``, ``A_log`` and ``D`` arrive as the rank's
heads. The gated norm's mean of squares spans every head: the rank's sum
over its channels is summed over the group (forward and backward). The
output projection's partial product is summed onto the rank's block. The
cache holds the rank's heads' SSM state and a conv window of its x
channels and all of B and C.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.linear_attention import gla_scan, gla_step


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_state
    return d_in, nh, conv_ch


def init(gen: torch.Generator, cfg, device="cuda"):
    d = cfg.d_model
    d_in, nh, conv_ch = _dims(cfg)
    dtype = getattr(torch, cfg.param_dtype)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale

    proj_out = 2 * d_in + 2 * cfg.ssm_state + nh  # x, z, B, C, dt
    return {
        "in_proj": normal((d, proj_out), d**-0.5),
        "conv_w": normal((cfg.ssm_conv_width, conv_ch), 0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "out_proj": normal((d_in, d), d_in**-0.5),
        "norm_scale": torch.zeros((d_in,), dtype=dtype, device=device),
    }


def param_axes(cfg):
    """The logical axes of :func:`init`'s leaves."""
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("conv_width", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "dt_bias": ("ssm_heads",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "out_proj": ("ssm_inner", "embed"),
        "norm_scale": ("ssm_inner",),
    }


def init_cache(cfg, batch: int, dtype, device="cuda"):
    _, nh, conv_ch = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device),
    }


CACHE_AXES = {
    "ssm": ("batch", "ssm_heads", "ssm_state", None),
    "conv": ("batch", None, "ssm_inner"),
}


def _split_proj(proj, cfg, d_in):
    n = cfg.ssm_state
    return (proj[..., :d_in], proj[..., d_in:2 * d_in], proj[..., 2 * d_in:2 * d_in + n],
            proj[..., 2 * d_in + n:2 * d_in + 2 * n], proj[..., 2 * d_in + 2 * n:])


def _local_columns(params, cfg, tp):
    """The rank's columns of the packed leaves: ``in_proj``'s x, z and dt of
    its heads and all of B and C, the conv's x channels of its heads and all
    of B and C, in the packed order."""
    d_in, nh, _ = _dims(cfg)
    h, n2 = nh // tp.width, 2 * cfg.ssm_state
    c = h * cfg.ssm_head_dim
    xs = slice(tp.me * c, (tp.me + 1) * c)  # the rank's x channels
    zs = slice(d_in + xs.start, d_in + xs.stop)
    bc, dts = slice(2 * d_in, 2 * d_in + n2), slice(2 * d_in + n2 + tp.me * h, 2 * d_in + n2 + (tp.me + 1) * h)
    w, cw, cb = params["in_proj"], params["conv_w"], params["conv_b"]
    conv_bc = slice(d_in, d_in + n2)
    in_proj = torch.cat([w[:, xs], w[:, zs], w[:, bc], w[:, dts]], dim=1)
    conv_w = torch.cat([cw[:, xs], cw[:, conv_bc]], dim=1)
    conv_b = torch.cat([cb[xs], cb[conv_bc]])
    return in_proj, conv_w, conv_b


def _gated_norm(params, y, z, eps, tp=None, d_in=None):
    """y's RMS norm over every channel, gated by silu(z). Under tensor
    parallelism y holds the rank's channels of ``d_in``: its sum of squares
    is summed over the group."""
    yf = y.float()
    if tp is None:
        var = yf.square().mean(dim=-1, keepdim=True)
    else:
        var = tp.reduce(yf.square().sum(dim=-1, keepdim=True)) / d_in
    yn = yf * (var + eps) ** -0.5 * (1.0 + params["norm_scale"].float())
    return (yn * F.silu(z.float())).to(y.dtype)


def _causal_conv(windowed, w):
    """The depthwise conv over ``windowed`` (B, S + W - 1, ch), valid
    positions only, in f32: out[t] = sum_j windowed[t + j] w[j], summed in
    the order j = 0 .. W - 1 whatever S is."""
    x = windowed.float()
    w = w.float()
    width = w.shape[0]
    s = x.shape[1] - width + 1
    out = x[:, 0:s] * w[0]
    for j in range(1, width):
        out = out + x[:, j:j + s] * w[j]
    return out


def apply(params, x, cfg, *, cache=None, cache_index=None):
    """x: (B, S, d). Returns (y, new_cache): new tensors for the cache (None
    without one), in the JAX package's types (a decode's conv window in the
    type of the cache and the input promoted together). Under tensor
    parallelism (``params["tp"]``) x and y are the rank's block of the
    sequence and the cache is the rank's (see the module)."""
    tp = params.get("tp")
    if tp is None:
        return _apply(params, x, cfg, cache, cache_index, None)
    y, new_cache = _apply(params, tp.gather(x), cfg, cache, cache_index, tp)
    return tp.scatter(y), new_cache


def _apply(params, x, cfg, cache, cache_index, tp):
    """The layer over the whole sequence x, on every head or (``tp``) on the
    rank's; then y is a partial sum over the heads."""
    b, s, _ = x.shape
    d_in, nh, _ = _dims(cfg)
    hd, n = cfg.ssm_head_dim, cfg.ssm_state
    dtype = x.dtype
    if tp is None:
        in_proj, conv_w, conv_b, di = params["in_proj"], params["conv_w"], params["conv_b"], d_in
    else:
        (in_proj, conv_w, conv_b), di = _local_columns(params, cfg, tp), d_in // tp.width
    h, ch = di // hd, di + 2 * n
    proj = x @ in_proj.to(dtype)
    xin, z, bmat, cmat, dt = _split_proj(proj, cfg, di)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)  # (B, S, ch)

    decode = cache is not None and s == 1 and cache_index is not None
    if decode:  # in the type of the cache and the input promoted together
        window = torch.cat([cache["conv"], conv_in], dim=1)
    else:  # the left context: the cache's window (zeros when fresh), else zeros
        left = (cache["conv"].to(dtype) if cache is not None
                else torch.zeros((b, cfg.ssm_conv_width - 1, ch), dtype=dtype, device=x.device))
        window = torch.cat([left, conv_in], dim=1)
    conv_out = _causal_conv(window, conv_w.to(dtype)).to(dtype) + conv_b.to(dtype)
    new_conv = window[:, -(cfg.ssm_conv_width - 1):, :]
    conv_out = F.silu(conv_out.float()).to(dtype)
    xin = conv_out[..., :di]
    bmat = conv_out[..., di:di + n]
    cmat = conv_out[..., di + n:]

    dtp = torch.logaddexp(dt.float() + params["dt_bias"].float(), torch.zeros((), device=x.device))
    log_decay = dtp * -torch.exp(params["A_log"])  # (B, S, H): log a_t = dt * A

    xh = xin.reshape(b, s, h, hd)
    # linear-attention mapping: q = C, k = B (shared over heads), v = dt * x
    q = cmat[:, :, None, :].expand(b, s, h, n)
    k = bmat[:, :, None, :].expand(b, s, h, n)
    v = (xh.float() * dtp[..., None]).to(dtype)
    lw = log_decay[..., None].expand(b, s, h, n)

    new_cache = None
    if decode:
        y1, state = gla_step(cache["ssm"], q[:, 0], k[:, 0], v[:, 0], lw[:, 0], include_current=True)
        y = y1[:, None]
        new_cache = {"ssm": state, "conv": new_conv}
    else:
        y, state = gla_scan(q, k, v, lw, include_current=True,
                            initial_state=None if cache is None else cache["ssm"])
        if cache is not None:
            new_cache = {"ssm": state, "conv": new_conv}
    y = y + xh * params["D"].to(y.dtype)[None, None, :, None]
    y = _gated_norm(params, y.reshape(b, s, di), z, cfg.norm_eps, tp, d_in)
    return y.to(dtype) @ params["out_proj"].to(dtype), new_cache
