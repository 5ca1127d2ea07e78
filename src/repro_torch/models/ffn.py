"""Dense MLP and mixture-of-experts (the port of the JAX package's
``models/ffn.py``).

MoE is the reference's sort-based capacity dispatch in its ``gathered``
mode: route -> top-k -> a stable sort of each group's (token, choice)
list by expert -> rank within the expert -> scatter into an [E, C, D]
capacity buffer (a choice past its expert's capacity goes to the dump
slot E*C, which nothing reads) -> three batched expert products ->
gather back -> weighted combine, plus the shared expert.  Groups are
batch rows.  No TPU kernel sits behind it, so it is plain PyTorch.  The
expert-parallel modes run each model rank's share of the experts on a
device mesh (``moe_forward_shmap``), and a tensor-parallel rank its
slice of the experts (``moe_rank``, which both run).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, dense_init
from repro_torch.models.sharding import _ACT_MESH, _axis_size, \
    batch_mean, copy_to, groups, reduce_from


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


def mlp_forward(p, x, act: str, bias: bool = False, reduce=None):
    """The MLP.  A tensor-parallel rank passes its columns of the first
    products and its rows of ``w_down`` (``models/tp.py``): ``reduce``
    then sums the partial products over its ranks before ``b_down`` is
    added once."""
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_in"]
        if bias:
            h = h + p["b_up"]
        h = act_fn(h, act)
    y = h @ p["w_down"]
    if reduce is not None:
        y = reduce(y)
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


def _dispatch_group_local(x, idx, n_local: int, capacity: int):
    """Sort-based capacity dispatch of each group to the experts
    [0, n_local), the reference's vmapped ``_dispatch_group_local``.

    x: [G, S, D]; idx: [G, S, k] int, shifted so this rank's experts are
    [0, n_local); a choice of another rank's expert goes to the dump slot
    n_local*C.  Returns (buffer [G, n_local, C, D], dest [G, S*k],
    valid [G, S*k], order [G, S*k]): ``order`` sorts the flat (token,
    choice) list by expert, stably, so a choice's rank within its expert
    follows token order; the first C choices of an expert land at
    ``e * C + rank``, the others at the dump slot, which several may
    write and none reads."""
    G, S, k = idx.shape
    E, C, D = n_local, capacity, x.shape[-1]
    flat_e = idx.reshape(G, S * k).long().clamp(-1, E)
    flat_e = torch.where(flat_e < 0, E, flat_e)     # another rank's expert
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = torch.zeros((G, E + 1), dtype=torch.long, device=x.device
                         ).scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(-1) - counts            # exclusive
    rank = torch.arange(S * k, device=x.device) - offsets.gather(1, sorted_e)
    valid = (rank < C) & (sorted_e < E)
    dest = torch.where(valid, sorted_e * C + rank, E * C)
    src = x.gather(1, (order // k)[..., None].expand(G, S * k, D))
    buf = x.new_zeros((G, E * C + 1, D)).scatter(
        1, dest[..., None].expand(G, S * k, D), src)
    return buf[:, :-1].reshape(G, E, C, D), dest, valid, order


def _dispatch_group(x, idx, n_experts: int, capacity: int):
    """The dispatch to all ``n_experts`` experts, the reference's vmapped
    ``_dispatch_group``: ``_dispatch_group_local`` with every expert
    local, so no choice reaches the dump slot but by capacity."""
    return _dispatch_group_local(x, idx, n_experts, capacity)


def _experts_combine(p, buf, dest, valid, order, weights, S, k):
    """The expert products of the capacity buffer [B, E, C, D] with the
    expert leaves [E, ...] in ``p``, gathered back to (token, choice)
    order and combined with the top-k weights: [B, S, D]."""
    B, E, C, D = buf.shape
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, p["w_up"])
    out = torch.einsum("becf,efd->becd", h, p["w_down"]).reshape(B, E * C, D)
    gathered = out.gather(
        1, dest.clamp(max=E * C - 1)[..., None].expand(B, S * k, D))
    gathered = torch.where(valid[..., None], gathered, 0.0)
    unsorted = torch.zeros_like(gathered).scatter(
        1, order[..., None].expand_as(gathered), gathered)
    return (unsorted * weights.reshape(B, S * k, 1).to(buf.dtype)
            ).reshape(B, S, k, D).sum(2)


def _aux_loss(probs, idx, m):
    """Load-balance auxiliary (switch-style): E * sum_e f_e * P_e, with
    f_e from the (not differentiable) choices and P_e the mean
    probability, both means over the global batch."""
    E = m.n_experts
    f_e = batch_mean(F.one_hot(idx, E).float().sum(2), (0, 1)) / m.top_k
    P_e = batch_mean(probs, (0, 1))
    return E * (f_e * P_e).sum() * m.aux_loss_coef


def moe_rank(p, x, cfg, experts, lo: int, copy, reduce,
             shared_split: bool = False):
    """The MoE layer as one rank of a ``model`` group computes it, the
    body of ``moe_forward_shmap`` and of the tensor-parallel layer
    (``models/tp.py``).  ``experts`` holds the rank's expert leaves
    [E_l, ...], of the experts [lo, lo + E_l).  Every row is routed over
    all E experts by the whole router in ``p`` and dispatched to the
    rank's own at the reference's capacity C = max(int(S * k / E *
    capacity_factor), 1), so a choice past its expert's capacity is
    dropped as the gathered path drops it.  The rows and the top-k
    weights enter the rank's part through ``copy`` and its partial
    output leaves through ``reduce``, once for the layer: with
    ``shared_split`` the shared expert (this rank's column slice of it)
    adds its partial to that sum, else it runs whole after it.  The aux
    loss comes from the whole router's probabilities, the same on every
    rank."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    C = max(int(S * k / E * m.capacity_factor), 1)
    probs, weights, idx = _route(p, x, m)
    aux = _aux_loss(probs, idx, m)
    xl, wl = copy(x), copy(weights)
    buf, dest, valid, order = _dispatch_group_local(
        xl, idx - lo, experts["w_gate"].shape[0], C)
    y = _experts_combine(experts, buf, dest, valid, order, wl, S, k)
    if "shared" in p and shared_split:
        y = y + mlp_forward(p["shared"], xl, "silu_gated")
    y = reduce(y)
    if "shared" in p and not shared_split:
        y = y + mlp_forward(p["shared"], x, "silu_gated")
    return y, aux


def moe_forward_shmap(p, x, cfg, mesh):
    """Expert parallelism over the mesh's ``model`` axis (moe_mode
    'ep_shmap'; 'ep' too, see ``moe_forward``).

    Activations are replicated along ``model``, so each model rank has
    every token: it routes them all, dispatches only to its E/m local
    experts (``_MOE_RULES`` shard the expert leaves' E over ``model``),
    computes them with its own expert weights, combines its partial
    per-token outputs, and one all-reduce over ``model`` finishes the
    layer (``moe_rank`` on the rank's rows of the whole expert leaves).
    Differentiable: the tokens and the top-k weights enter the local
    part through ``copy_to`` (their gradient is summed over ``model``)
    and the partial outputs leave through ``reduce_from``, so every
    model rank gets the whole gradient of x and of the router, and each
    the gradient of its own experts' rows of the expert leaves."""
    E = cfg.moe.n_experts
    mm = _axis_size(mesh, "model")
    if E % mm:
        raise ValueError(f"{E} experts over a model axis of {mm}")
    E_l = E // mm
    lo = mesh.get_local_rank("model") * E_l
    grp = groups(mesh, ("model",))
    local = {n: p[n][lo:lo + E_l] for n in ("w_gate", "w_up", "w_down")}
    return moe_rank(p, x, cfg, local, lo, lambda t: copy_to(t, grp),
                    lambda t: reduce_from(t, grp))


def moe_forward(p, x, cfg):
    """x: [B, S, D] -> (y, aux loss).  Groups are batch rows, and the
    capacity C = max(int(S * k / E * capacity_factor), 1) follows the
    length S of the segment run: the prompt in prefill, the suffix of a
    radix hit, 1 in decode.

    moe_mode 'ep_shmap' with a mesh installed (``activation_sharding``)
    whose model axis divides E runs ``moe_forward_shmap``, as the
    reference does; otherwise the gathered math.  The reference's 'ep'
    is the gathered math with XLA hints that move the capacity buffer to
    the experts' ranks and back, the same numbers; on an installed mesh
    the port runs it through the same local-experts path as 'ep_shmap'."""
    if cfg.moe_mode not in ("gathered", "ep", "ep_shmap"):
        raise ValueError(f"moe_mode {cfg.moe_mode!r}: expected gathered, "
                         "ep or ep_shmap")
    m = cfg.moe
    if cfg.moe_mode != "gathered":
        mesh = _ACT_MESH["mesh"]
        if mesh is not None and m.n_experts % _axis_size(mesh, "model") == 0:
            return moe_forward_shmap(p, x, cfg, mesh)
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    C = max(int(S * k / E * m.capacity_factor), 1)
    probs, weights, idx = _route(p, x, m)
    aux = _aux_loss(probs, idx, m)
    buf, dest, valid, order = _dispatch_group(x, idx, E, C)
    y = _experts_combine(p, buf, dest, valid, order, weights, S, k)
    if m.n_shared:
        y = y + mlp_forward(p["shared"], x, "silu_gated")
    return y, aux
