"""Preference-optimization objectives (counterpart of ``prefs/losses.py``).

Direct Preference Optimization (Rafailov et al., 2023): given a prompt with a
*chosen* and a *rejected* completion, push the policy's likelihood ratio over
the frozen reference toward the chosen side:

    loss = -log sigmoid( beta * [ (pi_c - ref_c) - (pi_r - ref_r) ] )

where each term is a per-sequence MASKED sum of token logprobs (prompt tokens
excluded — only completion targets count, the mask convention of
``train/losses.py``).  The reward model's Bradley–Terry objective scores each
sequence with a scalar head over the same logits.

All math in f32.  Where the reference takes ``log_softmax`` over the
vocabulary and gathers the targets, the port gathers the target logits and
subtracts ``logsumexp``: one f32 copy of the (B, S, V) logits exists, not a
second full log-probability tensor (4.2 GB at ``llama3-8b``'s 128256-wide
vocabulary over 16 × 512 rows).  The reordering moves each token logprob by
f32 rounding only (the tests hold the four functions to rel 1e-6 of the
reference's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _target_logprobs(logits: torch.Tensor, tokens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(tok_lp (B, S-1), lg (B, S-1, V))``: each next-token target's f32
    logprob, and the f32 logit rows it was taken from (a view when the
    logits are f32 already)."""
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    tok_lp = torch.gather(lg, -1, targets[..., None])[..., 0] - torch.logsumexp(lg, dim=-1)
    return tok_lp, lg


def masked_sequence_logprobs(logits: torch.Tensor, tokens: torch.Tensor,
                             loss_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sequence sum of next-token logprobs over masked targets.

    logits: (B, S, V); tokens: (B, S) int; loss_mask: (B, S) — 1 where the
    *target* token counts (completion tokens; prompt and padding are 0).
    Returns (B,) f32.  Position ``t`` of the mask gates the prediction OF
    token ``t``, as in :func:`train.losses.next_token_loss`."""
    tok_lp, _ = _target_logprobs(logits, tokens)
    if loss_mask is None:
        return tok_lp.sum(dim=-1)
    return (tok_lp * loss_mask[:, 1:].to(torch.float32)).sum(dim=-1)


def reward_scores(logits: torch.Tensor, tokens: torch.Tensor, loss_mask: torch.Tensor,
                  head: dict[str, torch.Tensor]) -> torch.Tensor:
    """Scalar reward per sequence from a head ``{"a": (), "w": (V,), "b": ()}``
    over the trunk's logits:

        a * mean masked target logprob  +  pooled_logits @ w  +  b

    where ``pooled_logits`` is the masked mean over completion positions of
    the f32 logit rows (a batched product with the mask, so no masked copy
    of the logits is made).  With ``a=1, w=0, b=0`` the score is the mean
    completion logprob.  Returns (B,) f32."""
    tok_lp, lg = _target_logprobs(logits, tokens)
    mask = loss_mask[:, 1:].to(torch.float32)
    count = torch.clamp(mask.sum(dim=-1), min=1.0)
    mean_lp = (tok_lp * mask).sum(dim=-1) / count
    pooled = torch.einsum("bsv,bs->bv", lg, mask) / count[:, None]
    return head["a"] * mean_lp + pooled @ head["w"] + head["b"]


def bradley_terry_loss(chosen_scores: torch.Tensor, rejected_scores: torch.Tensor
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Pairwise Bradley–Terry objective over scalar rewards, both (B,) f32:
    ``loss = -log sigmoid(s_chosen - s_rejected)``.  Metrics (detached):
    ``bt_accuracy`` (pairs ranked correctly), ``reward_margin`` (mean score
    gap), ``score_chosen``, ``score_rejected`` and ``loss``."""
    margin = chosen_scores - rejected_scores
    loss = -F.logsigmoid(margin).mean()
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "reward_margin": margin.mean(),
            "bt_accuracy": (margin > 0).to(torch.float32).mean(),
            "score_chosen": chosen_scores.mean(),
            "score_rejected": rejected_scores.mean(),
        }
    return loss, metrics


def dpo_loss(policy_chosen_lp: torch.Tensor, policy_rejected_lp: torch.Tensor,
             ref_chosen_lp: torch.Tensor, ref_rejected_lp: torch.Tensor, beta: float
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The DPO objective over per-sequence logprobs, all (B,) f32.  The
    reference logprobs are constants (``.detach()``, the reference's
    ``stop_gradient``).  Metrics (detached): ``reward_margin`` (mean of
    beta·[(pi_c-ref_c)-(pi_r-ref_r)]), ``dpo_accuracy`` (pairs with a
    positive margin), ``reward_chosen``, ``reward_rejected`` and ``loss``."""
    chosen_reward = beta * (policy_chosen_lp - ref_chosen_lp.detach())
    rejected_reward = beta * (policy_rejected_lp - ref_rejected_lp.detach())
    margin = chosen_reward - rejected_reward
    loss = -F.logsigmoid(margin).mean()
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "reward_margin": margin.mean(),
            "dpo_accuracy": (margin > 0).to(torch.float32).mean(),
            "reward_chosen": chosen_reward.mean(),
            "reward_rejected": rejected_reward.mean(),
        }
    return loss, metrics
