"""The port's config registry (``repro_torch.configs``) against the JAX
package's: every ported config and its smoke variant equal their JAX
twins field by field, and ``list_archs`` is the reference's ten archs
in its order (deepseek-v3-671b first): every family is ported."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs import llama_paper as jllama
from repro_torch import configs
from repro_torch.configs import llama_paper as llama

WINDOWED = ["starcoder2-3b", "command-r-35b", "deepseek-67b",
            "nemotron-4-340b"]
MOE = "llama4-scout-17b-a16e"
MLA = "deepseek-v3-671b"
VLM = "qwen2-vl-7b"
HYBRID = "zamba2-7b"
XLSTM = "xlstm-350m"
AUDIO = "seamless-m4t-medium"


def _fields(cfg):
    return [(f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg)]


@pytest.mark.parametrize("arch", WINDOWED)
@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_windowed_configs_equal_jax(arch, which):
    cfg = getattr(configs, which)(arch)
    want = getattr(jconfigs, which)(arch)
    assert _fields(cfg) == _fields(want)
    assert cfg.window and cfg.family == "dense"
    assert configs.param_count(cfg) == jconfigs.param_count(want)


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_moe_config_equals_jax(which):
    cfg = getattr(configs, which)(MOE)
    want = getattr(jconfigs, which)(MOE)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.family == "moe" and cfg.moe.top_k == 1 and cfg.window
    assert configs.param_count(cfg) == jconfigs.param_count(want)


@pytest.mark.parametrize("name", ["LLAMA31_8B", "LLAMA31_70B",
                                  "LLAMA31_405B", "smoke"])
def test_llama_paper_configs_equal_jax(name):
    cfg, want = getattr(llama, name), getattr(jllama, name)
    if name == "smoke":
        cfg, want = cfg(), want()
    assert _fields(cfg) == _fields(want)


def test_list_archs_is_the_ported_subset_in_reference_order():
    """Every arch of the reference registry is ported, in its order; the
    registry keeps no list of unported archs."""
    got = configs.list_archs()
    assert sorted(got) == sorted(WINDOWED + [MOE, MLA, VLM, HYBRID, XLSTM,
                                             AUDIO])
    assert got == jconfigs.list_archs() and got[0] == MLA
    assert not hasattr(configs, "UNPORTED")


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_mla_config_equals_jax_and_loads(which):
    """deepseek-v3-671b (A11.3) is ported: its config and smoke variant
    equal the JAX ones, MLA and MTP included, and the port builds it."""
    cfg = getattr(configs, which)(MLA)
    want = getattr(jconfigs, which)(MLA)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.attn_kind == "mla" and cfg.mtp and cfg.family == "moe"
    assert configs.param_count(cfg) == jconfigs.param_count(want)
    from repro_torch.models import backbone as bb
    bb.check_family(cfg)


@pytest.mark.parametrize("arch,family,params", [
    (VLM, "vlm", 7_615_283_200), (HYBRID, "hybrid", 6_751_911_936)])
@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_vlm_and_hybrid_configs_equal_jax_and_load(arch, family, params,
                                                   which):
    """qwen2-vl-7b (A11.4) and zamba2-7b (A11.5) are ported: each config
    and smoke variant equals the JAX one field by field (its SSMConfig
    and frontend fields included), the published configs count the
    reference's params, and the port builds them."""
    cfg = getattr(configs, which)(arch)
    want = getattr(jconfigs, which)(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.family == family
    assert configs.param_count(cfg) == jconfigs.param_count(want)
    if which == "get_config":
        assert configs.param_count(cfg)[0] == params
    from repro_torch.models import backbone as bb
    bb.check_family(cfg)


@pytest.mark.parametrize("arch,item", [
    ("xlstm-350m", "A11.6"), ("seamless-m4t-medium", "A11.7"),
])
def test_unported_arch_names_its_roadmap_item(arch, item):
    """xlstm-350m (ROADMAP A11.6) and seamless-m4t-medium (A11.7), the
    last two archs once refused, are ported: each config and smoke
    variant loads and equals the JAX one field by field (the XLSTMConfig
    and the encoder-decoder fields included), ``param_count`` is the
    reference's, and the port builds them."""
    assert arch in jconfigs.list_archs() and arch in configs.list_archs()
    for which in ("get_config", "get_smoke"):
        cfg = getattr(configs, which)(arch)
        want = getattr(jconfigs, which)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert configs.param_count(cfg) == jconfigs.param_count(want)
        from repro_torch.models import backbone as bb
        bb.check_family(cfg)
    fam = configs.get_config(arch).family
    assert fam == ("ssm" if item == "A11.6" else "audio")


def test_input_shapes_skips_and_combos_equal_jax():
    """The dry run's input shapes, its skipped (arch, shape) pairs with
    their reasons, and ``combos`` with and without the skips; the
    registry exports what the reference's ``__all__`` names."""
    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    assert configs.SKIPS == jconfigs.SKIPS
    for skips in (False, True):
        assert configs.combos(skips) == jconfigs.combos(skips)
    assert len(configs.combos()) == 4 * 10 - 3
    assert configs.__all__ == jconfigs.__all__
    assert all(hasattr(configs, n) for n in configs.__all__)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_segment_lengths_and_layer_counts_equal_jax(arch):
    """``segment_lengths``, ``counted_layers`` (scan groups 1, 2 and 3)
    and ``real_layers`` of every arch's config and smoke, for every step
    kind, at every input shape's sequence length and at none."""
    from repro.models import backbone as jbb
    from repro_torch.models import backbone as bb
    lens = [0] + sorted({s.seq_len for s in jconfigs.INPUT_SHAPES.values()})
    for which in ("get_config", "get_smoke"):
        cfg = getattr(configs, which)(arch)
        jcfg = getattr(jconfigs, which)(arch)
        for kind in ("train", "prefill", "decode"):
            for sl in lens:
                assert bb.segment_lengths(cfg, kind, sl) == \
                    jbb.segment_lengths(jcfg, kind, sl), (which, kind, sl)
                assert bb.real_layers(cfg, kind, sl) == \
                    jbb.real_layers(jcfg, kind, sl)
                for u in (1, 2, 3):
                    assert bb.counted_layers(cfg, u, kind, sl) == \
                        jbb.counted_layers(jcfg, u, kind, sl)
    full = configs.get_config(arch)
    if arch == "deepseek-v3-671b":          # the reference's own units
        assert bb.real_layers(full) == 61 and bb.counted_layers(full, 2) == 5
    if arch == "llama4-scout-17b-a16e":
        assert bb.segment_lengths(full, "train", 4096) == [48]
