"""Stand-ins for every dry-run input: tensors on the ``meta`` device with
the reference's shapes and dtypes, and no storage behind them (the port
of the JAX package's ``launch/inputspecs.py``, whose ``ShapeDtypeStruct``
leaves these replace).

Token ids are int32, as the reference's.  ``decode_specs`` builds the
cache through the port's own ``serve.init_cache`` on ``meta`` (the
reference traces its ``init_cache`` with ``jax.eval_shape``), so even
``long_500k``'s 524288-slot caches cost no memory.  The cache's ``pos``
is the port's host int cursor, 0 as ``init_cache`` leaves it, where the
reference's is a 0-d int32 array.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def frontend_specs(cfg: ArchConfig, B: int, dtype=torch.bfloat16):
    out = {}
    if cfg.frontend == "vision":
        out["patch_embeds"] = _spec((B, cfg.frontend_tokens, cfg.d_model),
                                    dtype)
    if cfg.frontend == "audio":
        out["frame_embeds"] = _spec((B, cfg.frontend_tokens, cfg.d_model),
                                    dtype)
    return out


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                      dtype=torch.bfloat16):
    B, S = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _spec((B, S), torch.int32),
        "behavior_logp": _spec((B, S), torch.float32),
        "advantages": _spec((B, S), torch.float32),
        "mask": _spec((B, S), torch.float32),
    }
    batch.update(frontend_specs(cfg, B, dtype))
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                        dtype=torch.bfloat16):
    B = shape.global_batch
    batch = {"tokens": _spec((B, shape.seq_len), torch.int32)}
    batch.update(frontend_specs(cfg, B, dtype))
    return batch


def decode_specs(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16):
    """(cache, token spec) for one ``decode_step``."""
    from repro_torch.models.serve import init_cache
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, dtype, device=META)
    return cache, _spec((B, 1), torch.int32)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16):
    """Dispatch per shape kind: the dry run's single entry point."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape, dtype)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape, dtype)}
    if shape.kind == "decode":
        cache, tokens = decode_specs(cfg, shape, dtype)
        return {"cache": cache, "tokens": tokens}
    raise ValueError(shape.kind)
