"""Section-7 performance model (a copy of the JAX package's
``core/theory.py``, numpy only): Table-2 memory accounting, eta curves,
and the constrained optimizers for the synchronous baseline (problem 6)
and LlamaRL (problem 7), plus a numeric check of Theorem 7.5.

Universal constants (Def. 7.2): G0 GPUs, B0 global batch, M0 per-GPU
memory, W0 model bytes; b_t/b_g micro/decoding batch; m_t/m_g model-parallel
degrees; theta = trainer GPU fraction.

Memory model (Table 2):
  trainer:   4 W0 / m_t + A_t b_t / m_t     (weights + adam(2) + grads + acts)
  generator: 1 W0 / m_g + K_g b_g / m_g     (weights + KV cache)

Step-time model (Def. 7.3/7.4):
  T_sync  = B0/G0 * m * (eta_t(b_t) + eta_g(b_g))                      (2)
  T_async = B0/G0 * max(eta_t m_t / theta, eta_g m_g / (1-theta))      (3)

eta curves are monotone decreasing in b (Assumption 7.1); we default to the
amortized form eta(b) = alpha + beta / b, which Fig. 5 exhibits, but any
callable works -- the theorem only needs monotonicity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class HWConfig:
    G0: int                 # total devices
    B0: int                 # global batch (samples per RL step)
    M0: float               # per-device memory (bytes)
    W0: float               # model weights (bytes)
    A_t: float              # activation bytes per train sample
    K_g: float              # KV-cache bytes per decoding slot


@dataclass(frozen=True)
class EtaCurve:
    """eta(b) = alpha + beta / b  (per-sample seconds)."""
    alpha: float
    beta: float

    def __call__(self, b):
        return self.alpha + self.beta / np.maximum(b, 1)


def fit_eta(batch_sizes, per_sample_times) -> EtaCurve:
    """Least-squares fit of eta(b) = alpha + beta/b to measurements."""
    b = np.asarray(batch_sizes, float)
    y = np.asarray(per_sample_times, float)
    X = np.stack([np.ones_like(b), 1.0 / b], axis=1)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    return EtaCurve(alpha=max(float(coef[0]), 0.0),
                    beta=max(float(coef[1]), 0.0))


def trainer_mem(hw: HWConfig, b_t, m_t):
    return (4 * hw.W0 + hw.A_t * b_t) / m_t


def generator_mem(hw: HWConfig, b_g, m_g):
    return (hw.W0 + hw.K_g * b_g) / m_g


def t_sync(hw: HWConfig, eta_t, eta_g, b_t, b_g, m):
    return hw.B0 / hw.G0 * m * (eta_t(b_t) + eta_g(b_g))


def t_async(hw: HWConfig, eta_t, eta_g, b_t, b_g, m_t, m_g, theta):
    return hw.B0 / hw.G0 * max(eta_t(b_t) * m_t / theta,
                               eta_g(b_g) * m_g / (1 - theta))


def _batch_grid(max_b: int = 1 << 14):
    out = [1]
    while out[-1] < max_b:
        out.append(out[-1] * 2)
    return out


def solve_sync(hw: HWConfig, eta_t, eta_g,
               max_b: int = 1 << 14) -> Dict:
    """Problem (6): min over (b_t, b_g, m) with the *shared* memory bound.
    By Lemma B.1 the optimum saturates the constraint, so m is implied."""
    best = None
    for b_t in _batch_grid(max_b):
        for b_g in _batch_grid(max_b):
            need = (4 * hw.W0 + hw.A_t * b_t) + (hw.W0 + hw.K_g * b_g)
            m = need / hw.M0              # continuous relaxation (Lemma B.1)
            if m > hw.G0:
                continue
            t = t_sync(hw, eta_t, eta_g, b_t, b_g, m)
            if best is None or t < best["T"]:
                best = {"T": t, "b_t": b_t, "b_g": b_g, "m": m}
    return best


def solve_async(hw: HWConfig, eta_t, eta_g,
                max_b: int = 1 << 14) -> Dict:
    """Problem (7): independent constraints; Lemma B.2/B.3 give
    m = mem/M0 saturation and theta equalizing the two sides."""
    best_t = None
    for b_t in _batch_grid(max_b):
        m_t = (4 * hw.W0 + hw.A_t * b_t) / hw.M0
        val = eta_t(b_t) * m_t
        if best_t is None or val < best_t["val"]:
            best_t = {"val": val, "b_t": b_t, "m_t": m_t}
    best_g = None
    for b_g in _batch_grid(max_b):
        m_g = (hw.W0 + hw.K_g * b_g) / hw.M0
        val = eta_g(b_g) * m_g
        if best_g is None or val < best_g["val"]:
            best_g = {"val": val, "b_g": b_g, "m_g": m_g}
    Tt, Tg = best_t["val"], best_g["val"]
    theta = Tt / (Tt + Tg)                 # Lemma B.3 third identity
    T = hw.B0 / hw.G0 * max(Tt / theta, Tg / (1 - theta))
    return {"T": T, "theta": theta, **best_t, **best_g}


def speedup(hw: HWConfig, eta_t, eta_g, max_b: int = 1 << 14) -> Dict:
    s = solve_sync(hw, eta_t, eta_g, max_b)
    a = solve_async(hw, eta_t, eta_g, max_b)
    return {"sync": s, "async": a, "speedup": s["T"] / a["T"],
            "theorem_7_5_holds": a["T"] < s["T"]}


# --------------------------------------------------- paper-scale presets ---

def llama_hw(model_params_b: float, n_gpus: int, global_batch: int = 2048,
             mem_gb: float = 80.0, seq: int = 8192) -> HWConfig:
    """H100-cluster preset shaped after the paper's Table 3 settings."""
    W0 = model_params_b * 1e9 * 2                 # bf16 weights
    # activation bytes per sample (rough: 20 * d_model-equivalent * seq)
    A_t = 2.5e6 * model_params_b ** (1 / 3) * seq / 8192
    K_g = 4.0e5 * model_params_b ** (2 / 3) * seq / 8192
    return HWConfig(G0=n_gpus, B0=global_batch, M0=mem_gb * 1e9, W0=W0,
                    A_t=A_t, K_g=K_g)
