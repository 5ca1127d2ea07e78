"""Dense MLP and mixture-of-experts (the port of the JAX package's
``models/ffn.py``).

MoE is the reference's sort-based capacity dispatch in its ``gathered``
mode: route -> top-k -> a stable sort of each group's (token, choice)
list by expert -> rank within the expert -> scatter into an [E, C, D]
capacity buffer (a choice past its expert's capacity goes to the dump
slot E*C, which nothing reads) -> three batched expert products ->
gather back -> weighted combine, plus the shared expert.  Groups are
batch rows.  No TPU kernel sits behind it, so it is plain PyTorch; the
expert-parallel modes need a device mesh (ROADMAP A12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, dense_init


def mlp_params(gen, n_layers: int, d_model: int, d_ff: int, act: str, dtype,
               device, bias: bool = False):
    """Stacked [n_layers, ...] MLP params in the reference's key layout."""
    L = n_layers
    if act == "silu_gated":
        p = {"w_gate": dense_init(gen, (L, d_model, d_ff), dtype, device),
             "w_up": dense_init(gen, (L, d_model, d_ff), dtype, device),
             "w_down": dense_init(gen, (L, d_ff, d_model), dtype, device)}
    else:
        p = {"w_in": dense_init(gen, (L, d_model, d_ff), dtype, device),
             "w_down": dense_init(gen, (L, d_ff, d_model), dtype, device)}
    if bias:
        p["b_up"] = torch.zeros((L, d_ff), dtype=dtype, device=device)
        p["b_down"] = torch.zeros((L, d_model), dtype=dtype, device=device)
    return p


def mlp_forward(p, x, act: str, bias: bool = False):
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_in"]
        if bias:
            h = h + p["b_up"]
        h = act_fn(h, act)
    y = h @ p["w_down"]
    if bias:
        y = y + p["b_down"]
    return y


# ------------------------------------------------------------------- MoE ---

def moe_params(gen, cfg, n_layers: int, dtype, device):
    """Stacked [n_layers, ...] MoE params in the reference's key layout.
    The router is fp32 in a tree of any dtype, as the route runs in fp32;
    the expert leaves [L, E, D, F] draw with the reference's fan-in, the
    per-layer leaf's ``shape[0]``, which is E."""
    m = cfg.moe
    D, L, E = cfg.d_model, n_layers, m.n_experts
    Fe = m.d_expert or cfg.d_ff
    p = {"w_router": dense_init(gen, (L, D, E), torch.float32, device),
         "w_gate": dense_init(gen, (L, E, D, Fe), dtype, device, fan_in=E),
         "w_up": dense_init(gen, (L, E, D, Fe), dtype, device, fan_in=E),
         "w_down": dense_init(gen, (L, E, Fe, D), dtype, device, fan_in=E)}
    if m.n_shared:
        p["shared"] = mlp_params(gen, L, D, m.n_shared * Fe, "silu_gated",
                                 dtype, device)
    return p


def _route(p, x, m):
    """Router probabilities [..., E] and the top-k weights and expert
    indices [..., k], all from fp32 logits.  Equal probabilities go to the
    lower expert first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order, and sigmoid probabilities tie once fp32 logits
    saturate), hence the stable descending sort."""
    logits = x.float() @ p["w_router"]
    if m.router == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :m.top_k], idx[..., :m.top_k]
    if m.router == "sigmoid":
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    return probs, vals, idx


def _dispatch_group(x, idx, n_experts: int, capacity: int):
    """Sort-based capacity dispatch of each group, the reference's
    vmapped ``_dispatch_group``.

    x: [G, S, D]; idx: [G, S, k] int.  Returns (buffer [G, E, C, D],
    dest [G, S*k], valid [G, S*k], order [G, S*k]): ``order`` sorts the
    flat (token, choice) list by expert, stably, so a choice's rank
    within its expert follows token order; the first C choices of an
    expert land at ``e * C + rank``, the others at the dump slot E*C,
    which several may write and none reads."""
    G, S, k = idx.shape
    E, C, D = n_experts, capacity, x.shape[-1]
    flat_e = idx.reshape(G, S * k).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=x.device
                         ).scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(-1) - counts            # exclusive
    rank = torch.arange(S * k, device=x.device) - offsets.gather(1, sorted_e)
    valid = rank < C
    dest = torch.where(valid, sorted_e * C + rank, E * C)
    src = x.gather(1, (order // k)[..., None].expand(G, S * k, D))
    buf = x.new_zeros((G, E * C + 1, D)).scatter(
        1, dest[..., None].expand(G, S * k, D), src)
    return buf[:, :-1].reshape(G, E, C, D), dest, valid, order


def moe_forward(p, x, cfg):
    """x: [B, S, D] -> (y, aux loss).  Groups are batch rows, and the
    capacity C = max(int(S * k / E * capacity_factor), 1) follows the
    length S of the segment run: the prompt in prefill, the suffix of a
    radix hit, 1 in decode."""
    if cfg.moe_mode != "gathered":
        raise NotImplementedError(
            f"moe_mode={cfg.moe_mode!r} shards the experts over a device "
            "mesh (ROADMAP A12); the port runs moe_mode='gathered'")
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    C = max(int(S * k / E * m.capacity_factor), 1)
    probs, weights, idx = _route(p, x, m)

    # load-balance auxiliary (switch-style): E * sum_e f_e * P_e, with f_e
    # from the (not differentiable) choices and P_e the mean probability
    f_e = F.one_hot(idx, E).float().sum(2).mean((0, 1)) / k
    P_e = probs.mean((0, 1))
    aux = E * (f_e * P_e).sum() * m.aux_loss_coef

    buf, dest, valid, order = _dispatch_group(x, idx, E, C)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, p["w_up"])
    out = torch.einsum("becf,efd->becd", h, p["w_down"]).reshape(B, E * C, D)
    gathered = out.gather(
        1, dest.clamp(max=E * C - 1)[..., None].expand(B, S * k, D))
    gathered = torch.where(valid[..., None], gathered, 0.0)
    unsorted = torch.zeros_like(gathered).scatter(
        1, order[..., None].expand_as(gathered), gathered)
    y = (unsorted * weights.reshape(B, S * k, 1).to(x.dtype)
         ).reshape(B, S, k, D).sum(2)
    if m.n_shared:
        y = y + mlp_forward(p["shared"], x, "silu_gated")
    return y, aux
