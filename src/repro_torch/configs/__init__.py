"""Config registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)`` (the
port of the JAX package's ``configs/__init__.py``).

``list_archs()`` names the archs the port runs, in the reference
registry's order.  An arch of the reference registry whose family is not
ported yet raises ``NotImplementedError`` naming the ROADMAP item that
brings it.
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
    "deepseek-67b":           "repro_torch.configs.deepseek_67b",
    "command-r-35b":          "repro_torch.configs.command_r_35b",
    "qwen2-vl-7b":            "repro_torch.configs.qwen2_vl_7b",
    "llama4-scout-17b-a16e":  "repro_torch.configs.llama4_scout_17b_a16e",
    "starcoder2-3b":          "repro_torch.configs.starcoder2_3b",
}

# the reference registry's other archs: the ROADMAP item that ports each
UNPORTED = {
    "xlstm-350m":             "A11.6 (SSM)",
    "seamless-m4t-medium":    "A11.7 (audio encoder-decoder)",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch_id: str):
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is ported with ROADMAP {UNPORTED[arch_id]}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()


__all__ = ["ArchConfig", "param_count", "list_archs", "get_config",
           "get_smoke"]
