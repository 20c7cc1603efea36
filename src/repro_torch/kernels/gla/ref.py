"""Plain PyTorch versions of chunked gated linear attention (GLA), forward
and backward, layout (B, S, H, ·).

The forward is the JAX package's ``gla_ref``: the exact per-step
recurrence, one step per position, so it takes any S::

    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t,   w_t = exp(log_w_t)
    y_t = q_t · S_t                          (include_current=True; Mamba2)
    y_t = q_t · (S_{t-1} + diag(u) k_t ⊗ v_t)  (include_current=False; RWKV6)

with an f32 state and ``u`` the optional RWKV6 bonus. The backward is
autograd through that forward (``torch.func.vjp``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def gla_fwd_ref(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,       # (B, S, H, K)
    v: torch.Tensor,       # (B, S, H, V)
    log_w: torch.Tensor,   # (B, S, H, K), <= 0
    *,
    bonus_u: Optional[torch.Tensor] = None,        # (H, K)
    include_current: bool = True,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, V) in v's dtype, final state (B, H, K, V) f32)."""
    b, s, h, kd = q.shape
    vd = v.shape[-1]
    if initial_state is None:
        state = torch.zeros((b, h, kd, vd), dtype=torch.float32, device=q.device)
    else:
        state = initial_state.float()
    q32, k32, v32 = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    ys = []
    for t in range(s):
        outer = k32[:, t, :, :, None] * v32[:, t, :, None, :]
        new_state = state * w[:, t, :, :, None] + outer
        if include_current:
            read = new_state
        elif bonus_u is not None:
            read = state + bonus_u.float()[None, :, :, None] * outer
        else:
            read = state
        ys.append(torch.einsum("bhk,bhkv->bhv", q32[:, t], read))
        state = new_state
    return torch.stack(ys, dim=1).to(v.dtype), state


def gla_bwd_ref(q, k, v, log_w, bonus_u, initial_state, d_y, d_final, *, include_current: bool):
    """Gradients of :func:`gla_fwd_ref` for the cotangents ``d_y`` (of y) and
    ``d_final`` (of the final state; None for zero). Returns (dq, dk, dv,
    dlog_w, du, ds0), each in its input's type; du and ds0 are None where
    ``bonus_u`` and ``initial_state`` are."""
    names = ("q", "k", "v", "log_w", "bonus_u", "initial_state")
    given = {n: t for n, t in zip(names, (q, k, v, log_w, bonus_u, initial_state)) if t is not None}

    def fwd(*tensors):
        args = dict(zip(given, tensors))
        return gla_fwd_ref(args["q"], args["k"], args["v"], args["log_w"],
                           bonus_u=args.get("bonus_u"), include_current=include_current,
                           initial_state=args.get("initial_state"))

    (y, final), vjp = torch.func.vjp(fwd, *given.values())
    d_final = torch.zeros_like(final) if d_final is None else d_final.float()
    grads = dict(zip(given, vjp((d_y.to(y.dtype), d_final))))
    return tuple(grads.get(n) for n in names)


# -- the chunked form, step for step as the CUDA kernels compute it ---------
#
# Chunks of ``chunk`` positions (64 in the kernels), each cut into sub-chunks
# of ``sub`` rows (16: one mma tile). W is the inclusive prefix sum of log_w
# along a chunk, E the exponent with which row t reads (W[t], or W[t-1] with
# W[-1] = 0 when the current token is not included), W_Q = W at the chunk's
# end. Every decay is one exp of a difference that is <= 0: a pair (t, u) in
# different sub-chunks is split at a reference row r between them
# (u <= r <= E's row of t), exp(E[t] - W[u]) = exp(E[t] - W[r]) exp(W[r] - W[u]),
# so the off-diagonal blocks are plain products of decayed operands; only
# the diagonal blocks take one exp per (t, u, channel) term (the forward cuts
# each 16 x 16 one again at row 8; the backward's dq and dk take it whole).
# ``exponents``, where given, collects the largest argument of every exp.


def _exp(x: torch.Tensor, exponents: Optional[list]) -> torch.Tensor:
    if exponents is not None and x.numel():
        exponents.append(x.max().item())
    return torch.exp(x)


def _to_chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, N, chunk, D) f32, rows past S zero."""
    b, s, h, d = x.shape
    n = -(-s // chunk)
    x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, n * chunk - s))
    return x.reshape(b, n, chunk, h, d).permute(0, 3, 1, 2, 4)


def _from_chunks(x: torch.Tensor, s: int) -> torch.Tensor:
    b, h, n, chunk, d = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, d)[:, :s]


def _decays(log_w: torch.Tensor, include_current: bool, chunk: int):
    lw = _to_chunks(log_w, chunk)
    w = lw.cumsum(-2)
    e = w if include_current else torch.nn.functional.pad(w[..., :-1, :], (0, 0, 1, 0))
    return w, e, w[..., -1, :]


def _mask(n: int, include_current: bool, device) -> torch.Tensor:
    t = torch.arange(n, device=device)
    return t[None, :] <= t[:, None] if include_current else t[None, :] < t[:, None]


def _diag_decay(w, e, i, sub, include_current, exponents):
    """exp(E[t] - W[u]) of diagonal block i, (..., sub t, sub u, K): masked
    pairs are -inf before the exp."""
    rows = slice(i * sub, (i + 1) * sub)
    diff = e[..., rows, None, :] - w[..., None, rows, :]
    diff = diff.masked_fill(~_mask(sub, include_current, w.device)[..., None], -torch.inf)
    return _exp(diff, exponents)


def _ref_row(w: torch.Tensor, r: int) -> torch.Tensor:
    """W at reference row r, (..., 1, K); W[-1] = 0."""
    return w[..., r:r + 1, :] if r >= 0 else torch.zeros_like(w[..., :1, :])


def _reference_product(q, k, w, e, t_rows, u_rows, r, exponents):
    """(q exp(E - W[r]))[t_rows] (k exp(W[r] - W))[u_rows]^T: the scores of
    a block whose u all lie at or before row r and whose t read at or after
    it."""
    wr = _ref_row(w, r)
    qt = q[..., t_rows, :] * _exp(e[..., t_rows, :] - wr, exponents)
    kt = k[..., u_rows, :] * _exp(wr - w[..., u_rows, :], exponents)
    return qt @ kt.transpose(-1, -2)


def _intra_scores(q, k, w, e, sub, include_current, exponents):
    """A[t, u] = sum_c q[t,c] k[u,c] exp(E[t,c] - W[u,c]) over visible pairs,
    as the forward's output pass forms it. Off-diagonal blocks of
    t-sub-chunk i (all u before row 16 i) come from the reference row
    r = 16 i - 1. A diagonal block is cut again at its middle row: its two
    8 x 8 diagonal blocks take one exp a term, its lower-left 8 x 8 block
    comes from the reference row 16 i + 7."""
    chunk, half = q.shape[-2], sub // 2
    a = q.new_zeros(q.shape[:-1] + (chunk,))
    for i in range(chunk // sub):
        for j in range(2):
            start = i * sub + j * half
            rows = slice(start, start + half)
            d = _diag_decay(w, e, start // half, half, include_current, exponents)
            a[..., rows, rows] = torch.einsum("...tc,...uc,...tuc->...tu", q[..., rows, :], k[..., rows, :], d)
        mid = i * sub + half
        a[..., mid:mid + half, i * sub:mid] = _reference_product(
            q, k, w, e, slice(mid, mid + half), slice(i * sub, mid), mid - 1, exponents)
        if i:
            r = i * sub - 1
            a[..., i * sub:(i + 1) * sub, :r + 1] = _reference_product(
                q, k, w, e, slice(i * sub, (i + 1) * sub), slice(0, r + 1), r, exponents)
    return a


def _chunk_states(k, v, w, w_q, initial_state, exponents):
    """Local pass: each chunk's (k exp(W_Q - W))^T v; state pass: the scan
    S_{n+1} = S_n exp(W_Q) + that over chunks. Returns (chunk-start states
    (B, H, N, K, V), final state)."""
    kv = (k * _exp(w_q[..., None, :] - w, exponents)).transpose(-1, -2) @ v
    decay = _exp(w_q, exponents)
    b, h, n, kd, vd = kv.shape
    state = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=k.device)
             if initial_state is None else initial_state.float())
    starts = []
    for i in range(n):
        starts.append(state)
        state = state * decay[:, :, i, :, None] + kv[:, :, i]
    return torch.stack(starts, dim=2), state


def gla_fwd_chunked_ref(q, k, v, log_w, *, bonus_u=None, include_current: bool = True,
                        initial_state=None, chunk: int = 64, sub: int = 16,
                        exponents: Optional[list] = None):
    """The forward as the kernels compute it: local pass, state pass, output
    pass y = A v + (q exp(E)) S_n + (sum_c q u k) v. f32 throughout. Returns
    (y (B, S, H, V) in v's type, final state (B, H, K, V) f32)."""
    s = q.shape[1]
    qc, kc, vc = (_to_chunks(t, chunk) for t in (q, k, v))
    w, e, w_q = _decays(log_w, include_current, chunk)
    starts, final = _chunk_states(kc, vc, w, w_q, initial_state, exponents)
    a = _intra_scores(qc, kc, w, e, sub, include_current, exponents)
    y = a @ vc + (qc * _exp(e, exponents)) @ starts
    if bonus_u is not None and not include_current:
        y = y + (qc * bonus_u.float()[None, :, None, None, :] * kc).sum(-1, keepdim=True) * vc
    return _from_chunks(y, s).to(v.dtype), final


def gla_bwd_chunked_ref(q, k, v, log_w, bonus_u, initial_state, d_y, d_final, *,
                        include_current: bool, chunk: int = 64, sub: int = 16,
                        exponents: Optional[list] = None):
    """Gradients of :func:`gla_fwd_chunked_ref` as the backward kernels
    compute them: the forward's chunk-start states; a local pass
    G_n = (q exp(E))^T dy; the reverse scan dS_n = dS_{n+1} exp(W_Q) + G_n
    (ds0 after chunk 0) with dW_Q = rowsum(dS_{n+1} S_{n+1}); then per chunk
    dA = dy v^T (masked) and

      dq = exp(E - W[r]) (dA k exp(W[r] - W) + exp(W[r]) (dy S_n^T)) + diagonal blocks,
           r = 16 i - 1 for t-sub-chunk i;
      dk = exp(W[p] - W) (dA^T q exp(E - W[p]) + exp(W_Q - W[p]) (v dS^T)) + diagonal blocks,
           p = 16 j + 15, the last row of u-sub-chunk j;
      dv = A^T dy + (k exp(W_Q - W)) dS_{n+1};
      dlog_w[s] = dW_Q + sum_{t >= s} (dW[t] + dE[t], or dE[t+1] when E[t] = W[t-1]),
           dE = q dq, dW = -k dk (bonus terms excluded);

    plus the bonus terms. The diagonal blocks' decay exp(E[t] - W[u]) is
    formed once and serves A, dq and dk. Returns (dq, dk, dv, dlog_w, du,
    ds0) as :func:`gla_bwd_ref` does."""
    s = q.shape[1]
    use_bonus = bonus_u is not None and not include_current
    qc, kc, vc, dy = (_to_chunks(t, chunk) for t in (q, k, v, d_y))
    w, e, w_q = _decays(log_w, include_current, chunk)
    starts, final = _chunk_states(kc, vc, w, w_q, initial_state, exponents)
    # local pass and reverse scan
    g = (qc * _exp(e, exponents)).transpose(-1, -2) @ dy
    decay = _exp(w_q, exponents)
    n = qc.shape[2]
    ds = torch.zeros_like(final) if d_final is None else d_final.float()
    ds_next = [None] * n
    for i in reversed(range(n)):
        ds_next[i] = ds
        ds = ds * decay[:, :, i, :, None] + g[:, :, i]
    ds_next = torch.stack(ds_next, dim=2)
    s_next = torch.cat([starts[:, :, 1:], final[:, :, None]], dim=2)
    dw_q = (ds_next * s_next).sum(-1)
    # per-chunk gradients
    mask = _mask(chunk, include_current, q.device)
    da = (dy @ vc.transpose(-1, -2)).masked_fill(~mask, 0.0)
    dq, dk = torch.zeros_like(qc), torch.zeros_like(kc)
    for i in range(chunk // sub):
        rows = slice(i * sub, (i + 1) * sub)
        r = i * sub - 1
        wr = _ref_row(w, r)
        acc = (dy[..., rows, :] @ starts.transpose(-1, -2)) * _exp(wr, exponents)
        if i:
            acc = acc + da[..., rows, :r + 1] @ (kc[..., :r + 1, :] * _exp(wr - w[..., :r + 1, :], exponents))
        dq[..., rows, :] = acc * _exp(e[..., rows, :] - wr, exponents)
        p = i * sub + sub - 1
        wp = w[..., p:p + 1, :]
        acc = (vc[..., rows, :] @ ds_next.transpose(-1, -2)) * _exp(w_q[..., None, :] - wp, exponents)
        later = slice(p + 1, chunk)
        acc = acc + da[..., later, rows].transpose(-1, -2) @ (
            qc[..., later, :] * _exp(e[..., later, :] - wp, exponents))
        dk[..., rows, :] = acc * _exp(wp - w[..., rows, :], exponents)
        d = _diag_decay(w, e, i, sub, include_current, exponents)
        block = da[..., rows, rows]
        dq[..., rows, :] += torch.einsum("...tu,...uc,...tuc->...tc", block, kc[..., rows, :], d)
        dk[..., rows, :] += torch.einsum("...tu,...tc,...tuc->...uc", block, qc[..., rows, :], d)
    a = _intra_scores(qc, kc, w, e, sub, include_current, exponents)
    dv = a.transpose(-1, -2) @ dy + (kc * _exp(w_q[..., None, :] - w, exponents)) @ ds_next
    de, dw = qc * dq, -kc * dk
    if not include_current:  # E[t] = W[t-1]: dE[t] lands on rows before t
        de = torch.nn.functional.pad(de[..., 1:, :], (0, 0, 0, 1))
    dlog_w = (dw + de).flip(-2).cumsum(-2).flip(-2) + dw_q[..., None, :]
    du = None
    if use_bonus:
        u = bonus_u.float()[None, :, None, None, :]
        dyv = (dy * vc).sum(-1, keepdim=True)
        coef = (qc * u * kc).sum(-1, keepdim=True)
        dq = dq + u * kc * dyv
        dk = dk + u * qc * dyv
        dv = dv + coef * dy
        du = (qc * kc * dyv).sum((0, 2, 3))
    elif bonus_u is not None:
        du = torch.zeros_like(bonus_u)
    grads = [_from_chunks(x, s) for x in (dq, dk, dv, dlog_w)]
    dq, dk, dv, dlog_w = (x.to(t.dtype) for x, t in zip(grads, (q, k, v, log_w)))
    return dq, dk, dv, dlog_w, du, (None if initial_state is None else ds)
