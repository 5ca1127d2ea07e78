"""State-space and recurrent blocks: Mamba2's chunked SSD and xLSTM's
mLSTM and sLSTM (the port of the JAX package's ``models/ssm.py``).

Train and prefill run the chunked SSD: within a chunk of c steps the
output is a masked quadratic form, across chunks a small state recurrence
carries h [B, H, P, N], so the work is O(S c).  Decode is the one-step
recurrence over that state and the causal convolution's last K - 1 inputs.
The reference's simplifications stay: one group (B and C shared by every
head) and no initial state for the chunked form.

The reference writes the intra-chunk output, the chunk states and the
inter-chunk output as four-operand einsums; here each is written as
pairwise products (a broadcast product, then one batched matmul), so no
[B, nc, c, c, H, P] tensor is ever formed: at zamba2-7b's widths (112
heads of 64, chunk 128) and [16, 256] that tensor would be 15 GB, against
235 MB for the [B, nc, c, c, H] decay.  The order of operations is the
reference's: ``dt``, ``A``, x, B and C in fp32, then the gate and
``rmsnorm`` in x's dtype, then ``w_out``, with one exception: the
intra-chunk decay is masked before its exp, not after, so its gradient
stays finite where the reference's is NaN (``mamba2_forward``).
``A_log``, ``D_skip`` and ``dt_bias`` are fp32 in a model of any dtype.

mLSTM is chunked gated linear attention of the same structure, in fp32:
within a chunk of 64 steps a masked quadratic form, across chunks the
matrix memory C [B, H, P, P] and its normalizer n [B, H, P], carried by
a loop over the chunks where the reference scans; decode is the one-step
recurrence.  Its three-operand einsums are pairwise products here too,
and its order is the reference's but for one step, as in the SSD: the
intra-chunk weights are masked before their exp, so the gradient stays
finite where a run of repeated tokens overflows the masked entries and
the reference's gradient is NaN (``_mlstm_core_chunked``).  A length
above 64 must be a multiple of 64, as in the reference, which asserts
it; neither package pads.  The
input gate's exp is not stabilised, as in the reference.  sLSTM is
strictly recurrent (h feeds the gates through the block-diagonal
``r_h``), so its forward is a loop over time of the one-step cell, with
the reference's max-stabilised exponential gates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rmsnorm


def mamba2_params(gen, cfg, n_layers: int, dtype, device):
    """Stacked [n_layers, ...] Mamba2 params in the reference's seven
    keys; the decay, skip and step-bias leaves in fp32."""
    s, D, L = cfg.ssm, cfg.d_model, n_layers
    d_in, H, _, N = _mamba_dims(cfg)
    conv_ch = d_in + 2 * N

    def full(n, value, dt):
        return torch.full((L, n), value, dtype=dt, device=device)
    return {
        "w_in": dense_init(gen, (L, D, 2 * d_in + 2 * N + H), dtype, device),
        "conv_w": dense_init(gen, (L, s.d_conv, conv_ch), dtype, device,
                             scale=3.0),
        "A_log": full(H, 0.0, torch.float32),
        "D_skip": full(H, 1.0, torch.float32),
        "dt_bias": full(H, 0.0, torch.float32),
        "gate_norm": full(d_in, 1.0, dtype),
        "w_out": dense_init(gen, (L, d_in, D), dtype, device),
    }


def _mamba_dims(cfg):
    """(d_inner, SSM heads, head dim, state size)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = s.n_ssm_heads or d_in // s.head_dim_ssm
    return d_in, H, s.head_dim_ssm, s.d_state


def _split_in(p, x, cfg):
    """The input projection cut into (z, x, B, C, dt)."""
    d_in, H, _, N = _mamba_dims(cfg)
    return (x @ p["w_in"]).split([d_in, d_in, N, N, H], dim=-1)


def _causal_conv(seq, w, prev=None):
    """Depthwise causal conv.  seq: [B, S, C]; w: [K, C]; prev: [B, K-1, C]
    (zeros when None).  Returns (silu(conv), the last K - 1 inputs, in
    seq's dtype)."""
    K = w.shape[0]
    if prev is None:
        prev = seq.new_zeros((seq.shape[0], K - 1, seq.shape[2]))
    full = torch.cat([prev, seq], dim=1)
    S = seq.shape[1]
    out = full[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + full[:, i:i + S] * w[i]
    new_state = full[:, full.shape[1] - (K - 1):] if K > 1 else prev
    return F.silu(out), new_state


def _softplus(x):
    """jax.nn.softplus: log(1 + e^x), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_forward(p, x, cfg, return_state: bool = False):
    """Chunked SSD.  x: [B, S, D] -> y [B, S, D]; with ``return_state``
    also the decode state after the last step: the convolution's last
    K - 1 inputs (fp32) and h [B, H, P, N] (fp32)."""
    s = cfg.ssm
    d_in, H, P, N = _mamba_dims(cfg)
    B_, S, _ = x.shape
    z, xc, Bc, Cc, dt = _split_in(p, x, cfg)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"])
    xc, Bc, Cc = conv_out.split([d_in, N, N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"])                   # [B, S, H]
    A = -torch.exp(p["A_log"])                                  # [H]
    xh = xc.reshape(B_, S, H, P).float()
    Bf, Cf = Bc.float(), Cc.float()                             # [B, S, N]

    c = min(s.chunk, S)
    pad = (-S) % c
    if pad:
        # dt = 0 on the padded steps: decay 1, nothing added to the state
        dt, Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bf, Cf))
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // c

    def r(t):   # [B, S, ...] -> [B, nc, c, ...]
        return t.reshape((B_, nc, c) + t.shape[2:])
    dtc, xch, Bch, Cch = r(dt), r(xh), r(Bf), r(Cf)
    cum = torch.cumsum(dtc * A, dim=2)                          # [B, nc, c, H]

    # within a chunk: y_i = sum_{j <= i} C_i.B_j exp(cum_i - cum_j) dt_j x_j
    # masked before the exp: above the diagonal seg > 0 may overflow to
    # inf, and the reference's exp-then-mask then has inf * 0 = NaN in its
    # gradient; the forward's values are the same either way
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,nc,c,c,H]
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    cb = Cch @ Bch.transpose(-1, -2)                            # [B,nc,c,c]
    w = (cb[..., None] * decay).permute(0, 1, 4, 2, 3)          # [B,nc,H,c,c]
    u = (dtc[..., None] * xch).permute(0, 1, 3, 2, 4)           # [B,nc,H,c,P]
    y_intra = w @ u                                             # [B,nc,H,c,P]
    del seg, decay, w

    # chunk states: h_g = h_{g-1} exp(sum la_g) + sum_j B_j dt_j x_j decay_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # [B,nc,c,H]
    u2 = ((dtc * decay_to_end)[..., None] * xch).permute(0, 1, 3, 4, 2)
    dBx = u2 @ Bch[:, :, None]                                  # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B, nc, H]
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for g in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, g, :, None, None] + dBx[:, g]
    h_prevs = torch.stack(h_prevs, dim=1)                       # [B,nc,H,P,N]

    # from the earlier chunks: y_i = C_i . h_{g-1} exp(cum_i)
    y_inter = (Cch[:, :, None] @ h_prevs.transpose(-1, -2)) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]         # [B,nc,H,c,P]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(
        B_, nc * c, H, P)[:, :S]
    y = y + p["D_skip"][None, None, :, None] * xh[:, :S]
    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"])
    out = y @ p["w_out"]
    if return_state:
        return out, {"conv": conv_state.float(), "ssm": h}
    return out


def mamba2_init_state(cfg, batch: int, dtype=torch.float32, *, device):
    """A zeroed decode state: the convolution's K - 1 inputs and h."""
    s = cfg.ssm
    d_in, H, P, N = _mamba_dims(cfg)
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_in + 2 * N),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device)}


def mamba2_decode(p, x, state, cfg):
    """One step.  x: [B, 1, D]; state: {"conv" [B, K-1, C], "ssm" [B, H,
    P, N]}.  Returns (y [B, 1, D], the new state: the convolution's
    inputs in x's dtype, h in fp32), as the reference does."""
    d_in, H, P, N = _mamba_dims(cfg)
    B_ = x.shape[0]
    z, xc, Bc, Cc, dt = _split_in(p, x, cfg)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"],
                                        prev=state["conv"].to(x.dtype))
    xc, Bc, Cc = conv_out.split([d_in, N, N], dim=-1)

    dt = _softplus(dt[:, 0].float() + p["dt_bias"])             # [B, H]
    A = -torch.exp(p["A_log"])
    xh = xc[:, 0].reshape(B_, H, P).float()
    Bf, Cf = Bc[:, 0].float(), Cc[:, 0].float()
    decay = torch.exp(dt * A)                                   # [B, H]
    h = state["ssm"] * decay[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bf[:, None, None, :]
    y = (h @ Cf[:, None, :, None])[..., 0] \
        + p["D_skip"][None, :, None] * xh                       # [B, H, P]
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"])
    return y @ p["w_out"], {"conv": conv_state, "ssm": h}


# ----------------------------------------------------------------- mLSTM ---

MLSTM_CHUNK = 64


def _mlstm_dims(cfg):
    """(inner width, heads, head dim)."""
    d_in = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def mlstm_params(gen, cfg, dtype, device):
    """One mLSTM cell's params in the reference's five keys: the up
    projection (value and gate), q/k/v, the input and forget gate
    logits, the norm and the down projection."""
    D = cfg.d_model
    d_in, H, _ = _mlstm_dims(cfg)
    return {"w_up": dense_init(gen, (D, 2 * d_in), dtype, device),
            "w_qkv": dense_init(gen, (d_in, 3 * d_in), dtype, device),
            "w_if": dense_init(gen, (d_in, 2 * H), dtype, device),
            "norm": torch.ones(d_in, dtype=dtype, device=device),
            "w_down": dense_init(gen, (d_in, D), dtype, device)}


def _mlstm_core_chunked(q, k, v, log_i, log_f, chunk, state=None):
    """Chunked gated-linear-attention mLSTM core, fp32.  q/k/v: [B, S, H,
    P]; log_i/log_f: [B, S, H]; state: (C [B, H, P, P], n [B, H, P]) or
    None (zeros).  Returns y [B, S, H, P] and the final (C, n).

    Laid out head-major, [B, nc, H, c, ...]: every product below is a
    broadcast product and one batched matmul."""
    B_, S, H, P = q.shape
    c = min(chunk, S)
    assert S % c == 0, f"mLSTM length {S} is no multiple of its chunk {c}"
    nc = S // c

    def r(t):   # [B, S, H, ...] -> [B, nc, H, c, ...]
        t = t.reshape((B_, nc, c) + t.shape[2:])
        return t.transpose(2, 3)
    scale = P ** -0.5
    qh, kh, vh = r(q), r(k), r(v)                           # [B,nc,H,c,P]
    li, cum = r(log_i), torch.cumsum(r(log_f), dim=-1)      # [B,nc,H,c]

    # within a chunk: w_ij = exp(cum_i - cum_j + log_i_j) for j <= i,
    # masked before the exp: above the diagonal seg sums the forget gates'
    # -log f, which a run of repeated tokens drives past 88, where exp
    # overflows to inf and the reference's exp-then-mask has inf * 0 = NaN
    # in its gradient; the forward's values are the same either way
    seg = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    w = torch.exp(seg.masked_fill(~causal, float("-inf")))  # [B,nc,H,c,c]
    qk = (qh @ kh.transpose(-1, -2)) * scale
    y_intra = (qk * w) @ vh                                 # [B,nc,H,c,P]
    n_intra = w @ kh                                        # [B,nc,H,c,P]
    del seg, w, qk

    # chunk states: C_g = C_{g-1} exp(sum log_f_g) + sum_j d_j k_j v_j^T
    dec_end = torch.exp(cum[..., -1:] - cum + li)           # [B,nc,H,c]
    dk = kh * dec_end[..., None]
    kv = dk.transpose(-1, -2) @ vh                          # [B,nc,H,P,P]
    kn = dk.sum(dim=-2)                                     # [B,nc,H,P]
    chunk_decay = torch.exp(cum[..., -1])                   # [B,nc,H]
    if state is None:
        C = torch.zeros((B_, H, P, P), dtype=torch.float32, device=q.device)
        n = torch.zeros((B_, H, P), dtype=torch.float32, device=q.device)
    else:
        C, n = state
    C_prev, n_prev = [], []
    for g in range(nc):
        C_prev.append(C)
        n_prev.append(n)
        dec = chunk_decay[:, g]
        C = C * dec[..., None, None] + kv[:, g]
        n = n * dec[..., None] + kn[:, g]
    C_prev = torch.stack(C_prev, dim=1)                     # [B,nc,H,P,P]
    n_prev = torch.stack(n_prev, dim=1)                     # [B,nc,H,P]

    # from the earlier chunks: y_i = exp(cum_i) q_i C_{g-1}
    dec_in = torch.exp(cum)[..., None]                      # [B,nc,H,c,1]
    qs = qh * scale
    y_inter = (qs @ C_prev) * dec_in
    n_inter = (qs @ n_prev[..., None]) * dec_in             # [B,nc,H,c,1]
    n_total = (n_intra * qs).sum(dim=-1, keepdim=True) + n_inter
    y = (y_intra + y_inter) / torch.clamp(n_total.abs(), min=1.0)
    return y.transpose(2, 3).reshape(B_, S, H, P), (C, n)


def _mlstm_in(p, x, cfg):
    """(gate [B, S, d_in], q, k, v [B, S, H, P] fp32, log_i, log_f
    [B, S, H] fp32) from the up, qkv and gate projections."""
    d_in, H, P = _mlstm_dims(cfg)
    B_, S, _ = x.shape
    val, gate = (x @ p["w_up"]).chunk(2, dim=-1)
    q, k, v = (t.reshape(B_, S, H, P).float()
               for t in (val @ p["w_qkv"]).chunk(3, dim=-1))
    log_i, f_raw = (val @ p["w_if"]).float().chunk(2, dim=-1)
    return gate, q, k, v, log_i, F.logsigmoid(f_raw)


def _mlstm_out(p, y, gate, x):
    """norm(y) * silu(gate), then the down projection; y in x's dtype."""
    y = rmsnorm(y.to(x.dtype), p["norm"]) * F.silu(gate)
    return y @ p["w_down"]


def mlstm_forward(p, x, cfg, state=None):
    """x: [B, S, D] -> (y [B, S, D], the state (C, n) after the last
    step), S at most 64 or a multiple of 64."""
    B_, S, _ = x.shape
    gate, q, k, v, log_i, log_f = _mlstm_in(p, x, cfg)
    y, new_state = _mlstm_core_chunked(q, k, v, log_i, log_f,
                                       chunk=MLSTM_CHUNK, state=state)
    return _mlstm_out(p, y.reshape(B_, S, -1), gate, x), new_state


def mlstm_init_state(cfg, batch: int, *, device):
    """Zeros: (C [B, H, P, P], n [B, H, P]), fp32."""
    _, H, P = _mlstm_dims(cfg)
    return (torch.zeros((batch, H, P, P), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, H, P), dtype=torch.float32, device=device))


def mlstm_decode(p, x, state, cfg):
    """One step.  x: [B, 1, D]; state (C, n).  Returns (y [B, 1, D], the
    new (C, n)); the input gate's exp is not stabilised, as in the
    reference."""
    B_ = x.shape[0]
    gate, q, k, v, log_i, log_f = _mlstm_in(p, x, cfg)
    q, k, v, log_i, log_f = (t[:, 0] for t in (q, k, v, log_i, log_f))
    C, n = state
    dec = torch.exp(log_f)                                  # [B, H]
    inp = torch.exp(log_i)
    ik = inp[..., None] * k                                 # [B, H, P]
    C = C * dec[..., None, None] + ik[..., None] * v[..., None, :]
    n = n * dec[..., None] + ik
    qs = q * q.shape[-1] ** -0.5
    y = (qs[:, :, None, :] @ C)[:, :, 0]                    # [B, H, P]
    denom = torch.clamp((qs * n).sum(dim=-1).abs(), min=1.0)
    y = (y / denom[..., None]).reshape(B_, 1, -1)
    return _mlstm_out(p, y, gate, x), (C, n)


# ----------------------------------------------------------------- sLSTM ---

def slstm_params(gen, cfg, dtype, device):
    """One sLSTM cell's params in the reference's four keys: the input
    weights of the z, i, f, o gates, the block-diagonal recurrent weights
    ``r_h`` [H, P, 4P] (the reference's init takes H as its fan-in), the
    norm and the output projection."""
    D, H = cfg.d_model, cfg.n_heads
    P = D // H
    return {"w_x": dense_init(gen, (D, 4 * D), dtype, device),
            "r_h": dense_init(gen, (H, P, 4 * P), dtype, device, fan_in=H),
            "norm": torch.ones(D, dtype=dtype, device=device),
            "w_out": dense_init(gen, (D, D), dtype, device)}


def slstm_init_state(cfg, batch: int, *, device):
    """{"h", "c", "n", "m"} [B, H, P] fp32: zeros, n at 1e-6."""
    D, H = cfg.d_model, cfg.n_heads
    z = torch.zeros((batch, H, D // H), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z + 1e-6, "m": z}


def _slstm_cell(state, wx_t, r_h):
    """One step.  wx_t: [B, H, P, 4] pre-activations from x; r_h: [H, P,
    4P] fp32."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    B_, H, P = h.shape
    rec = torch.bmm(h.transpose(0, 1), r_h).transpose(0, 1)  # [B, H, 4P]
    pre = wx_t + rec.reshape(B_, H, P, 4)
    z_t = torch.tanh(pre[..., 0])
    log_i = pre[..., 1]
    log_f = F.logsigmoid(pre[..., 2])
    o_t = torch.sigmoid(pre[..., 3])
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_out(p, h, x):
    """norm(h) in x's dtype, then the output projection."""
    B_, S = h.shape[:2]
    y = rmsnorm(h.reshape(B_, S, -1).to(x.dtype), p["norm"])
    return y @ p["w_out"]


def slstm_forward(p, x, cfg, state=None):
    """x: [B, S, D] -> (y [B, S, D], the state after the last step): the
    cell a step at a time (``r_h`` cast to fp32 once a call)."""
    D, H = cfg.d_model, cfg.n_heads
    B_, S, _ = x.shape
    wx = (x @ p["w_x"]).float().reshape(B_, S, H, D // H, 4)
    if state is None:
        state = slstm_init_state(cfg, B_, device=x.device)
    r_h = p["r_h"].float()
    hs = []
    for t in range(S):
        state = _slstm_cell(state, wx[:, t], r_h)
        hs.append(state["h"])
    return _slstm_out(p, torch.stack(hs, dim=1), x), state


def slstm_decode(p, x, state, cfg):
    """One step.  x: [B, 1, D].  Returns (y [B, 1, D], the new state)."""
    D, H = cfg.d_model, cfg.n_heads
    wx = (x[:, 0] @ p["w_x"]).float().reshape(x.shape[0], H, D // H, 4)
    state = _slstm_cell(state, wx, p["r_h"].float())
    return _slstm_out(p, state["h"][:, None], x), state
