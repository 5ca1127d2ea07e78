"""The only bridge between the JAX package's params and the port's.

``from_jax_numpy`` maps a nested dict of numpy arrays (the JAX params after
``jax.device_get``) key for key onto torch tensors; ``to_jax_numpy`` maps
back.  bfloat16 leaves travel as their raw ``uint16`` bits, because
``torch.from_numpy`` does not know the ml_dtypes bfloat16 that JAX hands
out, so the round trip is bit-exact in fp32 and in bf16.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve

# leaves the reference keeps in fp32 in a model of any dtype: a MoE
# router, and Mamba2's log decay, skip and step bias
FP32_KEYS = frozenset({"w_router", "A_log", "D_skip", "dt_bias"})


def _leaf_to_torch(a, dtype, device):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch tensors may be written
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_numpy(tree: Any, dtype: Optional[torch.dtype] = None,
                   device: DeviceLike = None) -> Any:
    """Nested dicts/lists of numpy arrays -> the same structure of tensors.
    ``dtype`` casts floating leaves (None keeps each leaf's own type),
    except those of ``FP32_KEYS`` (a MoE router, Mamba2's ``A_log``,
    ``D_skip`` and ``dt_bias``), which stay fp32 in a tree of any dtype
    as the reference keeps them."""
    dev = resolve(device)

    def go(x, key=None):
        if isinstance(x, dict):
            return {k: go(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return _leaf_to_torch(x, None if key in FP32_KEYS else dtype, dev)
    return go(tree)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes     # the numpy bfloat16 type JAX uses
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_jax_numpy(tree: Any) -> Any:
    """Inverse of ``from_jax_numpy``: tensors -> numpy arrays (bfloat16
    leaves as ml_dtypes bfloat16, bit for bit)."""
    if isinstance(tree, dict):
        return {k: to_jax_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax_numpy(v) for v in tree)
    return _leaf_to_numpy(tree)
