"""LM loss: next-token cross-entropy with padding + modality-prefix
masking, computed in fp32 with a vocab-padded logits mask.

Counterpart of ``repro/training/loss.py``."""
from __future__ import annotations

import torch


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor | None = None,
            vocab_size: int | None = None) -> tuple[torch.Tensor, dict]:
    """logits (B,S,Vp) vs targets (B,S).  ``mask`` (B,S) of {0,1}
    excludes padding; padded-vocab ids already carry -1e9 logits.
    ``accuracy`` counts the positions whose argmax (the first of equal
    maxima, as ``jnp.argmax``) is the target."""
    logits = logits.float()
    targets = targets.long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    mask = mask.float()
    total = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / total
    acc = ((logits.argmax(dim=-1) == targets) * mask).sum() / total
    return loss, {"loss": loss, "accuracy": acc, "tokens": total}
