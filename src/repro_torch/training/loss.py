"""LM loss: next-token cross-entropy with padding + modality-prefix
masking, computed in fp32 with a vocab-padded logits mask.

Counterpart of ``repro/training/loss.py``."""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import all_gather, all_max, \
    all_reduce


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


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, rt,
                       vocab_lo: int) -> torch.Tensor:
    """Each position's f32 negative log-likelihood from this rank's block
    of the vocabulary (``logits`` (B, S, n), ids ``vocab_lo`` on): the
    row max, the sum of exponentials and the target's logit each
    combined over tp, never a gather of the B·S·V logits."""
    logits = logits.float()
    n = logits.shape[-1]
    m = all_max(logits.detach().max(dim=-1).values, rt.mesh, rt.tp_axis)
    sumexp = rt.reduce_tp(torch.exp(logits - m[..., None]).sum(dim=-1))
    ids = targets.long() - vocab_lo
    hit = (ids >= 0) & (ids < n)
    picked = logits.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
    tgt = rt.reduce_tp(torch.where(hit, picked, torch.zeros_like(picked)))
    return torch.log(sumexp) + m - tgt


def lm_loss_sharded(logits: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor | None, rt, vocab_lo: int
                    ) -> tuple[torch.Tensor, dict]:
    """:func:`lm_loss` on one rank of a mesh: ``logits`` (B_loc, S, n)
    this rank's block of the vocabulary (ids ``vocab_lo`` on), over its
    rows of the batch, through :func:`vocab_parallel_nll`.  Returns (the
    rank's share of the loss, to differentiate: its rows' summed nll
    over the global token count, so the data ranks' gradients sum to the
    loss's; the metrics over the whole batch)."""
    mesh, tp, dp = rt.mesh, rt.tp_axis, rt.dp_axes
    targets = targets.long()
    nll = vocab_parallel_nll(logits, targets, rt, vocab_lo)
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    mask = mask.float()
    total = all_reduce(mask.sum(), mesh, dp).clamp_min(1.0)
    share = (nll * mask).sum() / total
    # the argmax over the whole vocabulary: the first rank with the
    # largest max, its first id (the first of equal maxima overall)
    val, arg = logits.detach().float().max(dim=-1)
    vals = all_gather(val[None], mesh, tp, 0)
    args = all_gather((arg + vocab_lo)[None], mesh, tp, 0)
    best = args.gather(0, vals.argmax(dim=0, keepdim=True))[0]
    acc = all_reduce(((best == targets) * mask).sum(), mesh, dp) / total
    loss = all_reduce(share.detach(), mesh, dp)
    return share, {"loss": loss, "accuracy": acc, "tokens": total}
