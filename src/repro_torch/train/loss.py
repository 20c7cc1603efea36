"""Next-token cross-entropy with router-aux and optional z-loss.

The label at position t is token t+1 (the last position is masked), so the
model input keeps the exact (B, seq_len) shape of the batch.

The logits' log-sum-exp and the label's logit come from one autograd
function (:class:`_LseAndLabel`) whose backward writes the logits'
gradient into one logits-sized buffer, in place: the bits of autograd's
``logsumexp`` and ``gather`` backwards and of their sum, at one f32 buffer
of (B, S, V) where those take five (at qwen2.5-3b's vocabulary and 4,096
positions, 2.49 GB each: the step's high-water mark).

Under tensor parallelism (a ``"tp"`` entry in the params) the model gives
each rank of a ``model`` group its slice of the vocabulary's logits, and
:class:`_SplitLseAndLabel` takes the same two terms over the slices: the
row maximum and the sums of exponentials over the group (in f32, summed in
position order), the label's logit from the rank whose slice holds it.
No rank holds the (B, S, V) logits whole.
"""
from __future__ import annotations

import torch


class _LseAndLabel(torch.autograd.Function):
    """(``torch.logsumexp(logits, -1)``, the logit at ``labels``)."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits, dim=-1)
        ctx.save_for_backward(logits, labels, lse)
        return lse, logits.gather(-1, labels[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g_lse, g_label):
        logits, labels, lse = ctx.saved_tensors
        if g_lse is None:
            grad = torch.zeros_like(logits)
        else:  # logsumexp's backward, g * exp(logits - lse), in place
            grad = logits - lse[..., None]
            grad.exp_()
            grad.mul_(g_lse[..., None])
        if g_label is not None:  # gather's: 0 + g at the labels, added to the above
            grad.scatter_add_(-1, labels[..., None], g_label[..., None])
        return grad, None


class _SplitLseAndLabel(torch.autograd.Function):
    """:class:`_LseAndLabel` of logits split over the vocabulary: ``logits``
    (B, S, V/M) the slice of the rank at position ``tp.me`` of its
    ``model`` group ``tp``. Every rank of the group gets the same bits; the
    backward is each rank's own slice's."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        vl = logits.shape[-1]
        local = labels - tp.me * vl
        mine = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        top = torch.stack(tp.all_gather(logits.amax(-1))).amax(0)
        label = torch.where(mine, logits.gather(-1, idx[..., None])[..., 0], torch.zeros((), device=logits.device))
        sums = tp.sum(torch.stack([(logits - top[..., None]).exp().sum(-1), label]))
        lse = top + sums[0].log()
        ctx.save_for_backward(logits, idx, mine, lse)
        return lse, sums[1]

    @staticmethod
    def backward(ctx, g_lse, g_label):
        logits, idx, mine, lse = ctx.saved_tensors
        if g_lse is None:
            grad = torch.zeros_like(logits)
        else:
            grad = logits - lse[..., None]
            grad.exp_()
            grad.mul_(g_lse[..., None])
        if g_label is not None:
            grad.scatter_add_(-1, idx[..., None], torch.where(mine, g_label, 0.0)[..., None])
        return grad, None, None


def lm_loss(model, params, batch, *, z_loss: float = 0.0, aux_weight: float = 0.01):
    """Returns (total loss, {"loss", "aux", "tokens"}), all f32 scalars."""
    logits, aux = model.forward(params, batch)  # (B, S, V) f32
    tokens = batch["tokens"].long()
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=logits.device)
    mask[:, -1] = 0.0
    tp = params.get("tp") if isinstance(params, dict) else None
    if tp is None:
        lse, true_logit = _LseAndLabel.apply(logits, labels)
    else:
        lse, true_logit = _SplitLseAndLabel.apply(logits, labels, tp)
    nll = (lse - true_logit) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * (lse.square() * mask).sum() / denom
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": denom}
