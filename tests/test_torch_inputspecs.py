"""The dry run's input stand-ins (``repro_torch.launch.inputspecs``)
against the JAX package's ``repro.launch.inputspecs``.

For every ``combos()`` pair, ``input_specs`` gives the reference's
shapes and dtypes leaf by leaf, each cache leaf of ``decode_specs``
included, as tensors on the ``meta`` device: nothing is allocated, so
``long_500k``'s 524288-slot caches cost no memory.  The cache's ``pos``
is the port's host int cursor (0), the reference's a 0-d int32.  (Only
``inputspecs`` and ``init_cache`` of the reference are imported:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported.)"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.launch import inputspecs as jspecs
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import inputspecs

COMBOS = configs.combos()


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _leaves(x, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): tree}


def test_combos_are_the_references():
    assert COMBOS == jconfigs.combos() and len(COMBOS) == 37
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in INPUT_SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in JSHAPES.items()}


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_match_the_reference(arch, shape):
    cfg = configs.get_config(arch)
    got = _leaves(inputspecs.input_specs(cfg, INPUT_SHAPES[shape]))
    want = _jax_leaves(jspecs.input_specs(jconfigs.get_config(arch),
                                          JSHAPES[shape]))
    assert set(got) == set(want)
    for path, leaf in got.items():
        ref = want[path]
        if path == "cache/pos":
            assert leaf == 0 and ref.shape == () and ref.dtype == jnp.int32
            continue
        assert isinstance(leaf, torch.Tensor) and leaf.is_meta, path
        assert tuple(leaf.shape) == tuple(ref.shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(ref.dtype), \
            path
    if INPUT_SHAPES[shape].kind == "train":
        assert got["batch/tokens"].dtype == torch.int32


def test_dtype_argument_reaches_the_frontend_and_cache():
    for arch, want in (("qwen2-vl-7b", "batch/patch_embeds"),
                       ("seamless-m4t-medium", "batch/frame_embeds")):
        got = _leaves(inputspecs.input_specs(
            configs.get_config(arch), INPUT_SHAPES["prefill_32k"],
            torch.float32))
        assert got[want].dtype == torch.float32
    cache, tok = inputspecs.decode_specs(configs.get_config("starcoder2-3b"),
                                         INPUT_SHAPES["long_500k"],
                                         torch.float32)
    assert tok.shape == (1, 1) and tok.dtype == torch.int32
    assert cache["segments"][0]["k"].dtype == torch.float32
    with pytest.raises(ValueError):
        inputspecs.input_specs(configs.get_config("starcoder2-3b"),
                               INPUT_SHAPES["train_4k"].__class__(
                                   "x", 8, 1, "eval"))
