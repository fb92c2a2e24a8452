"""Loss functions (counterpart of ``train/losses.py``): next-token
cross-entropy with a loss mask, f32 throughout."""

from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    loss_mask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Shifted cross-entropy.

    logits: (B, S, V); tokens: (B, S) int; loss_mask: (B, S) — 1 where the
    *target* token counts (e.g. completion tokens in SFT).  Returns the loss
    and ``{"loss", "accuracy", "target_tokens"}`` (the last two detached).
    """
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].to(torch.float32)
    if loss_mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    else:
        mask = loss_mask[:, 1:].to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc, "target_tokens": mask.sum()}
