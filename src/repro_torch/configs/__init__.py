"""Config registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)`` (the
port of the JAX package's ``configs/__init__.py``).

``list_archs()`` names the archs the port runs: all ten of the reference
registry, in its order.  ``combos()`` lists the (arch, input shape) pairs
of the dry run, less ``SKIPS``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ArchConfig, MLAConfig, MoEConfig, SSMConfig, XLSTMConfig,
    INPUT_SHAPES, ShapeSpec, param_count,
)

# the archs the port runs, in the reference registry's order
_MODULES = {
    "deepseek-v3-671b":       "repro_torch.configs.deepseek_v3_671b",
    "nemotron-4-340b":        "repro_torch.configs.nemotron_4_340b",
    "zamba2-7b":              "repro_torch.configs.zamba2_7b",
    "xlstm-350m":             "repro_torch.configs.xlstm_350m",
    "deepseek-67b":           "repro_torch.configs.deepseek_67b",
    "seamless-m4t-medium":    "repro_torch.configs.seamless_m4t_medium",
    "command-r-35b":          "repro_torch.configs.command_r_35b",
    "qwen2-vl-7b":            "repro_torch.configs.qwen2_vl_7b",
    "llama4-scout-17b-a16e":  "repro_torch.configs.llama4_scout_17b_a16e",
    "starcoder2-3b":          "repro_torch.configs.starcoder2_3b",
}


# (arch, shape) combos intentionally skipped, with reasons
SKIPS: Dict[tuple, str] = {
    ("deepseek-v3-671b", "long_500k"):
        "pure full-attention (MLA) arch; no windowed variant claimed",
    ("seamless-m4t-medium", "long_500k"):
        "enc-dec full attention; 500k-frame decode out of scope",
    ("qwen2-vl-7b", "long_500k"):
        "pure full-attention arch; no windowed variant claimed",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke()


def combos(include_skips: bool = False):
    """All (arch_id, shape_name) dry-run combos."""
    out = []
    for a in _MODULES:
        for s in INPUT_SHAPES:
            if not include_skips and (a, s) in SKIPS:
                continue
            out.append((a, s))
    return out


__all__ = [
    "ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
    "INPUT_SHAPES", "ShapeSpec", "param_count", "SKIPS",
    "list_archs", "get_config", "get_smoke", "combos",
]
