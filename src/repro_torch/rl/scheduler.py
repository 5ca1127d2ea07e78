"""Work tickets of the generator: ``RolloutJob``, the resumable in-flight
batch the generator's chunk hooks pass around, and ``RowJob``, the
row-granular ticket of the continuous-batching engine (copies of the JAX
package's ``rl/scheduler.py`` dataclasses; the chunk scheduler itself
comes with a later slice)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class RolloutJob:
    """A resumable in-flight batch: everything but the parked state."""
    batch_index: int
    params: Any                # snapshot at admission -- one version per batch
    weight_version: int
    key: Any                   # per-batch PRNG key; split once per chunk
    meta: Dict[str, Any]       # passed through to the emitted batch (answers)
    max_new: int
    chunk: int
    n_chunks: int
    bound: int = 0             # staleness bound in effect at admission
    chunks_done: int = 0
    busy_s: float = 0.0        # wall-clock spent advancing this job
    rid: Optional[int] = None  # partial-rollout cache id while parked


@dataclass
class RowJob:
    """Row-granular work ticket for the continuous-batching engine
    (``repro_torch.rl.engine``): one prompt's single completion, scheduled
    at sequence rather than batch granularity.  ``(batch_index, group,
    sib)`` identifies the row in its RLOO/AIPO group; ``weight_version``
    pins the committed version at admission, the per-row leg of the
    bounded-staleness contract ``0 <= version_floor - weight_version <=
    bound``."""
    batch_index: int           # the emitted batch this row's group feeds
    group: int                 # prompt index within the batch
    sib: int                   # sibling index within the group
    prompt: Any                # [Sp] int32 prompt tokens
    answer: Any                # passed through to the reward scorer
    bound: int = 0             # staleness bound in effect at enqueue
    weight_version: int = -1   # committed version pinned at admission
    slot: int = -1             # running-pool row while decoding
    chunks_done: int = 0
    max_chunks: int = 0        # per-row decode budget (straggler injection)
    enqueue_t: float = 0.0     # for queue-wait percentiles
    admit_t: float = 0.0
