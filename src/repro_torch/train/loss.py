"""Next-token cross-entropy with router-aux and optional z-loss.

The label at position t is token t+1 (the last position is masked), so the
model input keeps the exact (B, seq_len) shape of the batch.

The logits' log-sum-exp and the label's logit come from one autograd
function (:class:`_LseAndLabel`) whose backward writes the logits'
gradient into one logits-sized buffer, in place: the bits of autograd's
``logsumexp`` and ``gather`` backwards and of their sum, at one f32 buffer
of (B, S, V) where those take five (at qwen2.5-3b's vocabulary and 4,096
positions, 2.49 GB each: the step's high-water mark).
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


def lm_loss(model, params, batch, *, z_loss: float = 0.0, aux_weight: float = 0.01):
    """Returns (total loss, {"loss", "aux", "tokens"}), all f32 scalars."""
    logits, aux = model.forward(params, batch)  # (B, S, V) f32
    tokens = batch["tokens"].long()
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=logits.device)
    mask[:, -1] = 0.0
    lse, true_logit = _LseAndLabel.apply(logits, labels)
    nll = (lse - true_logit) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * (lse.square() * mask).sum() / denom
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": denom}
