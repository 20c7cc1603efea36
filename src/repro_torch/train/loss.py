"""Next-token cross-entropy with router-aux and optional z-loss.

The label at position t is token t+1 (the last position is masked), so the
model input keeps the exact (B, seq_len) shape of the batch.
"""
from __future__ import annotations

import torch


def lm_loss(model, params, batch, *, z_loss: float = 0.0, aux_weight: float = 0.01):
    """Returns (total loss, {"loss", "aux", "tokens"}), all f32 scalars."""
    logits, aux = model.forward(params, batch)  # (B, S, V) f32
    tokens = batch["tokens"].long()
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=logits.device)
    mask[:, -1] = 0.0
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels[..., None])[..., 0]
    nll = (lse - true_logit) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * (lse.square() * mask).sum() / denom
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": denom}
