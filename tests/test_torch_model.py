"""The port's dense model against the JAX package's on the smoke config,
fp32, with the JAX params carried across by ``convert``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.llama_paper import smoke
from repro.models import decode_step as jdecode
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro_torch import convert
from repro_torch.configs.llama_paper import smoke as tsmoke
from repro_torch.models import decode_step, forward_train, prefill
from repro_torch.models.common import apply_rope, rmsnorm

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jp = jinit(smoke(), jax.random.PRNGKey(0), jnp.float32)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    return jp, tp


def test_config_copy_matches():
    assert tsmoke() == tsmoke() and tsmoke().__dict__ == smoke().__dict__


def test_rmsnorm_and_rope_match():
    from repro.models.common import apply_rope as japply
    from repro.models.common import rmsnorm as jrms
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
        np.asarray(jrms(jnp.asarray(x), jnp.asarray(w))), atol=1e-6)
    pos = np.arange(5)[None].repeat(2, 0) + 1000
    np.testing.assert_allclose(
        apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 500000.0).numpy(),
        np.asarray(japply(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        atol=1e-5)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("variant", [
    {},                                     # llama: SwiGLU, untied, no bias
    {"act": "gelu", "bias": True, "tie_embeddings": True},
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_jax(variant, dtype):
    """The port's own init has the reference's keys, shapes and dtypes, so
    ``convert`` maps one onto the other key for key, and the same
    per-leaf scale 1/sqrt(fan_in)."""
    from repro_torch.models import init_params
    jp = jinit(smoke().replace(**variant), jax.random.PRNGKey(0),
               getattr(jnp, dtype))
    tp = init_params(tsmoke().replace(**variant), 0, getattr(torch, dtype),
                     device="cpu")
    assert _shapes(tp) == _shapes(jax.device_get(jp))
    w = tp["layers"]["attn"]["wq"].float()
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.05


@pytest.mark.parametrize("kind", ["silu", "gelu", "sq_relu"])
def test_act_and_layernorm_match(kind):
    from repro.models.common import act_fn as jact
    from repro.models.common import layernorm as jln
    from repro_torch.models.common import act_fn, layernorm
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        act_fn(torch.as_tensor(x), kind).numpy(),
        np.asarray(jact(jnp.asarray(x), kind)), atol=1e-5)
    np.testing.assert_allclose(
        layernorm(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
        np.asarray(jln(jnp.asarray(x), jnp.asarray(w))), atol=1e-5)


def test_forward_train_logits(models):
    jp, tp = models
    toks = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    want, _ = jforward(jp, smoke(), {"tokens": jnp.asarray(toks)})
    got, aux = forward_train(tp, tsmoke(), {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 24, 512) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < TOL


def test_forward_train_logits_biased_gelu_tied():
    """The dense family's other switches: biases, a plain GELU MLP and a
    tied head."""
    variant = {"act": "gelu", "bias": True, "tie_embeddings": True}
    jp = jinit(smoke().replace(**variant), jax.random.PRNGKey(4), jnp.float32)
    # random biases, so a dropped bias term shows
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 if path[-1].key.startswith("b") else a, jp)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, 512, (2, 24)).astype(np.int32)
    want, _ = jforward(jp, smoke().replace(**variant),
                       {"tokens": jnp.asarray(toks)})
    got, _ = forward_train(tp, tsmoke().replace(**variant),
                           {"tokens": torch.as_tensor(toks)})
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < TOL


def test_prefill_then_decode_logits(models):
    jp, tp = models
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 512, (3, 10)).astype(np.int32)
    steps = rng.integers(0, 512, (8, 3)).astype(np.int32)
    cache_len = 10 + 8
    jl, jc = jprefill(jp, smoke(), {"tokens": jnp.asarray(prompt)},
                      cache_len=cache_len, dtype=jnp.float32)
    tl, tc = prefill(tp, tsmoke(), {"tokens": torch.as_tensor(prompt)},
                     cache_len=cache_len, dtype=torch.float32)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < TOL
    for t in steps:
        jl, jc = jdecode(jp, smoke(), jc, jnp.asarray(t)[:, None])
        tl, tc = decode_step(tp, tsmoke(), tc, torch.as_tensor(t)[:, None])
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < TOL
    assert tc["pos"] == int(jc["pos"]) == 18
    seg, jseg = tc["segments"][0], jc["segments"][0]
    assert np.array_equal(seg["slot_pos"].numpy(), np.asarray(jseg["slot_pos"]))
    assert np.max(np.abs(seg["k"].numpy() - np.asarray(jseg["k"]))) < TOL


def test_other_families_raise():
    from repro_torch.models import init_params
    # MLA is ported (A11.3): it needs its MLAConfig
    with pytest.raises(ValueError, match="MLAConfig"):
        init_params(tsmoke().replace(attn_kind="mla"), device="cpu")
    assert init_params(tsmoke().replace(window=8), device="cpu")
    # every family is ported (A11): one without its sub-config raises
    with pytest.raises(ValueError, match="XLSTMConfig"):
        init_params(tsmoke().replace(family="ssm"), device="cpu")
    with pytest.raises(ValueError, match="enc_dec"):
        init_params(tsmoke().replace(family="audio"), device="cpu")
    from repro_torch.models import init_cache
    with pytest.raises(ValueError, match="dense|paged"):
        init_cache(tsmoke(), 1, 8, device="cpu", layout="ring")
