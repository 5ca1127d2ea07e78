"""AIPO train-step factory: loss assembly, remat, Adam update (the port of
the JAX package's ``train/trainstep.py``).

batch layout (everything right-aligned to the full token sequence):
  tokens        [B, T] int    -- prompt + sampled response
  behavior_logp [B, T] f32    -- mu's per-token logprob (0 on prompt)
  advantages    [B, T] f32    -- per-token advantage (0 on prompt)
  mask          [B, T] f32    -- 1 on *action* positions (response tokens)

Action position t is predicted by logits at t-1, so the loss aligns
``logits[:, :-1]`` with ``tokens[:, 1:]``: it passes the whole logits with
``n_valid = T - 1``, so the log-prob backward writes the logits' gradient
as it is and autograd scatters no slice.  The log-probs go through
``aipo.token_logprobs``, which streams the vocabulary in the forward and
the backward, so the step never builds a [B, T, V] fp32 log-softmax on top
of the logits themselves.  The functional step of the reference becomes
``torch.autograd.grad`` over the params' leaves.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.aipo import aipo_loss, token_logprobs
from repro_torch.device import DeviceLike
from repro_torch.models import forward_train, init_params
from repro_torch.models.sharding import batch_total
from repro_torch.train.optimizer import AdamState, adam_init, adam_update, \
    tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamState


def init_train_state(cfg, seed: int = 0, dtype=torch.float32,
                     device: DeviceLike = None) -> TrainState:
    params = init_params(cfg, seed, dtype, device)
    return TrainState(params=params, opt=adam_init(params))


def make_loss_fn(cfg, *, rho=4.0, clip_mode="aipo", kl_coef=0.0,
                 mtp_weight=0.1, remat=False, tp=None):
    """The loss of ``params`` on a batch: (loss, metrics).  With ``tp``
    (a ``models.tp.TPRank``) the params are a dense or MoE model's
    tensor-parallel shards: the forward is ``models.tp.forward_train``
    and the log-probs, the MTP head's too, are its vocabulary-parallel
    ones."""
    fwd, logprob = forward_train, None
    if tp is not None:
        from repro_torch.models import tp as tpmod

        def fwd(params, cfg, batch):
            return tpmod.forward_train(params, cfg, batch, tp)
        logprob = tp.token_logprob

    def loss_fn(params, batch):
        if remat:
            logits, aux = checkpoint(fwd, params, cfg, batch,
                                     use_reentrant=False)
        else:
            logits, aux = fwd(params, cfg, batch)
        T = logits.shape[1]
        loss, metrics = aipo_loss(
            logits,
            batch["tokens"][:, 1:],
            batch["behavior_logp"][:, 1:],
            batch["advantages"][:, 1:],
            batch["mask"][:, 1:],
            rho=rho, clip_mode=clip_mode, kl_coef=kl_coef,
            ref_logp=(batch["ref_logp"][:, 1:]
                      if kl_coef and "ref_logp" in batch else None),
            n_valid=T - 1, logprob=logprob)
        moe_aux = aux.get("moe_aux", 0.0)
        loss = loss + moe_aux
        if "mtp_logits" in aux and mtp_weight:
            # multi-token-prediction auxiliary CE on t+2 targets
            tgt = batch["tokens"][:, 2:]
            m = batch["mask"][:, 2:]
            lp = (logprob or token_logprobs)(aux["mtp_logits"], tgt,
                                             n_valid=T - 2)
            mtp_loss = -batch_total((lp * m).sum()) \
                / torch.clamp(batch_total(m.sum()), min=1.0)
            loss = loss + mtp_weight * mtp_loss
            metrics = dict(metrics, mtp_loss=mtp_loss.detach())
        if torch.is_tensor(moe_aux):
            moe_aux = moe_aux.detach()
        metrics = dict(metrics, moe_aux=moe_aux, total_loss=loss.detach())
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) with grads in the params' structure and
    dtypes, as ``jax.value_and_grad(..., has_aux=True)`` returns them."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg, *, lr=2e-7, rho=4.0, clip_mode="aipo", kl_coef=0.0,
                    max_grad_norm=1.0, weight_decay=0.0, mtp_weight=0.1,
                    remat=False, lr_fn=None, accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    The paper's optimizer setting: Adam, fixed lr 2e-7 (Sec. 8.1).
    accum_steps > 1 splits the batch into microbatches and accumulates
    fp32 gradients over them, averaged; the metrics are the last
    microbatch's, as the reference's scan returns them."""
    loss_fn = make_loss_fn(cfg, rho=rho, clip_mode=clip_mode, kl_coef=kl_coef,
                           mtp_weight=mtp_weight, remat=remat)

    def train_step(state: TrainState, batch) -> tuple:
        if accum_steps > 1:
            B = batch["tokens"].shape[0]
            if B % accum_steps:
                raise ValueError(f"batch of {B} does not split into "
                                 f"{accum_steps} microbatches")
            mb = B // accum_steps
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                (_, metrics), g = value_and_grad(loss_fn, state.params, micro)
                tree_map(lambda a, b: a.add_(b), grads, g)
                del g
            tree_map(lambda g: g.div_(accum_steps), grads)
        else:
            (_, metrics), grads = value_and_grad(loss_fn, state.params, batch)
        step_lr = lr_fn(state.opt.step) if lr_fn is not None else lr
        params, opt, opt_metrics = adam_update(
            state.params, grads, state.opt, lr=step_lr,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        return TrainState(params, opt), {**metrics, **opt_metrics}

    return train_step
