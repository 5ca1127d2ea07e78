"""State-space blocks: Mamba2's chunked SSD (the port of the Mamba2 half of
the JAX package's ``models/ssm.py``; xLSTM comes with ROADMAP A11.6).

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
