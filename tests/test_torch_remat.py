"""Per-layer rematerialization (``cfg.remat_layers``) against the JAX
package's, on the CPU.

The reference wraps each layer scan's body in ``jax.checkpoint`` when
``remat_layers`` is set: the decoder stacks (dense, windowed, MoE, MLA,
VLM), the hybrid's Mamba2 layers, the audio encoder's layers and its
decoder's.  The port runs each such layer under
``torch.utils.checkpoint``.  For a smoke of each of those families, one
loss and backward (``value_and_grad`` of ``make_loss_fn``) with
``remat_layers`` on equals the same with it off bit for bit: loss,
metrics and every gradient (the recompute runs the same operations on
the same inputs, the MoE's capacity drops included: the MoE smoke runs at
capacity factor 1, so tokens drop).  For one family of each kind of site
(a decoder stack, the hybrid's Mamba2 layers, the audio encoder and
decoder), the loss and backward with it on is within the family tests'
``STEP`` (1e-4) of the JAX package's with ``remat_layers=True`` from the
same init: loss and metrics relative to max(1, |value|), every leaf's
gradient relative to its largest |gradient|.  The xLSTM, whose layers no
scan wraps, gives the same results either way.  The params are the
port's init, crossed to the JAX package through ``convert``; the batches
are made with numpy from a seed; everything runs in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import llama_paper as jllama
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.configs import llama_paper
from repro_torch.models import backbone as bb
from repro_torch.models import init_params
from repro_torch.train import trainstep as ts

STEP = 1e-4
B, T = 2, 24


def _moe_drops(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


def _pair(arch, change=lambda c: c):
    if arch == "llama31-8b":
        return change(llama_paper.smoke()), change(jllama.smoke())
    return change(configs.get_smoke(arch)), change(jconfigs.get_smoke(arch))


# family -> (port cfg, JAX cfg): the windowed smoke at window 6 with every
# second layer global, so the stack runs in segments of both kinds
FAMILIES = {
    "dense": lambda: _pair("llama31-8b"),
    "windowed": lambda: _pair("starcoder2-3b", lambda c: c.replace(
        window=6, window_pattern=2)),
    "moe": lambda: _pair("llama4-scout-17b-a16e", _moe_drops),
    "mla": lambda: _pair("deepseek-v3-671b"),
    "vlm": lambda: _pair("qwen2-vl-7b"),
    "hybrid": lambda: _pair("zamba2-7b"),
    "audio": lambda: _pair("seamless-m4t-medium"),
}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, T), np.float32)
    mask[:, 8:] = rng.uniform(size=(B, T - 8)) > 0.1
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
        "behavior_logp": (rng.uniform(-8, -4, (B, T)) * mask
                          ).astype(np.float32),
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32),
        "mask": mask,
    }
    front = {"vision": "patch_embeds", "audio": "frame_embeds"}
    if cfg.frontend in front:
        batch[front[cfg.frontend]] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _port(cfg, params, batch, runs=None):
    """(loss, metrics, gradients by path) of one port loss + backward;
    ``runs`` gathers one entry each time a layer's work runs."""
    real = bb._run_layer

    def counted(*args):
        runs.append(1)
        return real(*args)

    if runs is not None:
        bb._run_layer = counted
    try:
        (loss, metrics), grads = ts.value_and_grad(ts.make_loss_fn(cfg),
                                                   params, batch)
    finally:
        bb._run_layer = real
    return loss, metrics, _paths(grads)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


def _same(a, b):
    (la, ma, ga), (lb, mb, gb) = a, b
    assert torch.equal(la, lb)
    assert set(ma) == set(mb)
    for k in ma:
        assert torch.equal(torch.as_tensor(ma[k]), torch.as_tensor(mb[k])), k
    assert set(ga) == set(gb)
    for p in ga:
        assert torch.equal(ga[p], gb[p]), p


def _init(tcfg, seed):
    """The port's params from ``seed`` and the same numbers as the JAX
    package's tree."""
    tp = init_params(tcfg, seed, torch.float32, device="cpu")
    return tp, jax.tree.map(jnp.asarray, convert.to_jax_numpy(tp))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_layers_is_bit_equal(family):
    """Bit-equal either way, and with it on every wrapped layer runs
    twice: in the forward and in its recompute."""
    tcfg, _ = FAMILIES[family]()
    seed = list(FAMILIES).index(family)
    tp, _ = _init(tcfg, seed)
    batch = {k: torch.as_tensor(v) for k, v in _batch(tcfg, seed).items()}
    on, off = [], []
    _same(_port(tcfg.replace(remat_layers=True), tp, batch, on),
          _port(tcfg, tp, batch, off))
    assert len(off) >= tcfg.n_layers and len(on) == 2 * len(off)


# one family for each kind of site the reference wraps: a decoder stack,
# the hybrid's Mamba2 layers, the audio encoder's and decoder's layers
@pytest.mark.parametrize("family", ["dense", "hybrid", "audio"])
def test_remat_layers_matches_jax(family):
    tcfg, jcfg = FAMILIES[family]()
    seed = list(FAMILIES).index(family)
    tp, jp = _init(tcfg, seed)
    batch = _batch(tcfg, seed)
    loss, metrics, grads = _port(
        tcfg.replace(remat_layers=True), tp,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jcfg.replace(remat_layers=True)), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    assert abs(float(loss) - float(jloss)) <= \
        STEP * max(1.0, abs(float(jloss)))
    for k in ("loss", "mean_ratio", "mean_logp", "moe_aux"):
        assert abs(float(metrics[k]) - float(jm[k])) <= \
            STEP * max(1.0, abs(float(jm[k]))), k
    jg = {tuple(p.key for p in path): np.asarray(leaf) for path, leaf in
          jax.tree_util.tree_flatten_with_path(jax.device_get(jg))[0]}
    assert sorted(jg) == sorted(grads)
    for p, want in jg.items():
        assert np.max(np.abs(grads[p].numpy() - want)) <= \
            STEP * max(np.max(np.abs(want)), 1e-30), p


def test_xlstm_is_the_same_either_way():
    """The xLSTM's layers run in a Python loop that no checkpoint wraps,
    as in the reference: ``remat_layers`` changes nothing."""
    cfg = configs.get_smoke("xlstm-350m")
    params, _ = _init(cfg, 0)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    runs = []
    _same(_port(cfg.replace(remat_layers=True), params, batch, runs),
          _port(cfg, params, batch))
    assert not runs
