"""Config registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)`` (the
port of the JAX package's ``configs/__init__.py``).

``list_archs()`` names the archs the port runs: all ten of the reference
registry, in its order.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig, param_count

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


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke()


__all__ = ["ArchConfig", "param_count", "list_archs", "get_config",
           "get_smoke"]
