"""AIPO: Asynchronous Importance-weighted Policy Optimization (paper Sec. 6;
the port of the JAX package's ``core/aipo.py``).

The learner update is

    sum_t  min(pi(y_t|x,y_<t) / mu(y_t|x,y_<t), rho) * A(x, y_<=t)
           * grad log pi(y_t|x,y_<t)

with a one-sided clip at rho; the clipped importance weight is a
stop-gradient coefficient.  ``clip_mode`` also carries the ablations:
"ppo" (double-sided clip and the PPO surrogate), "is_unclipped" (full IS),
"none" and "onpolicy" (weight 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.sharding import batch_total


def token_logprobs(logits, tokens, n_valid=None):
    """log pi(token) per position.  logits: [B, T, V]; tokens: [B, T], or
    [B, n_valid] to score only ``logits[:, :n_valid]``.  Streamed through
    the dispatch layer in the forward and the backward, so no [B, T, V]
    fp32 log-softmax is built."""
    return dispatch.token_logprob(logits, tokens, n_valid)


def importance_weights(logp, behavior_logp, *, rho: float,
                       clip_mode: str = "aipo", ppo_eps: float = 0.2):
    """Clipped IS coefficient (the caller's loss detaches it)."""
    ratio = torch.exp(logp - behavior_logp)
    if clip_mode == "aipo":
        return torch.clamp(ratio, max=rho)
    if clip_mode == "ppo":
        return torch.clamp(ratio, 1.0 - ppo_eps, 1.0 + ppo_eps)
    if clip_mode == "is_unclipped":
        return ratio
    if clip_mode in ("none", "onpolicy"):
        return torch.ones_like(ratio)
    raise ValueError(clip_mode)


def aipo_loss(logits, tokens, behavior_logp, advantages, mask, *,
              rho: float = 4.0, clip_mode: str = "aipo",
              ppo_eps: float = 0.2, kl_coef: float = 0.0,
              ref_logp: Optional[torch.Tensor] = None,
              n_valid: Optional[int] = None, logprob=None):
    """Scalar AIPO loss (negative clipped-IS policy-gradient surrogate).

    logits: [B, T, V] for action positions; tokens/behavior_logp/
    advantages/mask: [B, T].  With ``n_valid`` only ``logits[:, :n_valid]``
    are action positions and the rest are [B, n_valid].  Returns (loss,
    metrics); the metrics are detached 0-d tensors.  The sums and the
    mask's count are over the global batch (``batch_total``) when this
    rank runs its share of split rows.  ``logprob(logits, tokens,
    n_valid)`` scores the logits: ``token_logprobs`` by default, a
    tensor-parallel rank's ``TPRank.token_logprob`` for its vocabulary
    slice.
    """
    logp = (logprob or token_logprobs)(logits, tokens, n_valid)
    adv = advantages.float()
    if kl_coef and ref_logp is not None:
        # k1 estimator of KL(pi || pi_base), added as a per-token penalty
        adv = adv - kl_coef * (logp - ref_logp)
    w = importance_weights(logp, behavior_logp, rho=rho, clip_mode=clip_mode,
                           ppo_eps=ppo_eps).detach()
    if clip_mode == "ppo":
        # PPO surrogate (min of clipped/unclipped ratio objectives)
        ratio = torch.exp(logp - behavior_logp.detach())
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - ppo_eps, 1 + ppo_eps) * adv
        per_tok = -torch.minimum(unclipped, clipped)
    else:
        per_tok = -w * adv * logp
    m = mask.float()
    denom = torch.clamp(batch_total(m.sum()), min=1.0)
    loss = batch_total((per_tok * m).sum()) / denom
    with torch.no_grad():
        ratio_raw = torch.exp(logp - behavior_logp)
        sums = batch_total(torch.stack([
            (ratio_raw * m).sum(), ((ratio_raw > rho) * m).sum(),
            (logp * m).sum(), (adv * m).sum()])) / denom
        metrics = {"loss": loss.detach(), "mean_ratio": sums[0],
                   "clip_frac": sums[1], "mean_logp": sums[2],
                   "mean_adv": sums[3]}
    return loss, metrics
