"""Partial-rollout chunk scheduler (paper Sec. 4.2; the port of the JAX
package's ``rl/scheduler.py``).

``RolloutScheduler`` replaces the monolithic ``generate()`` call inside a
generator worker: admitted batches become resumable ``RolloutJob``s whose
``RolloutState`` is parked in a thread-safe ``PartialRolloutCache``
between chunks.  Each ``step()`` pops the highest-priority job off a work
heap, drives it one ``rollout_chunk`` forward, and either harvests it (all
sequences done, or token budget exhausted) or requeues it with its KV
cache and cursor intact.  Finished batches are emitted the moment they
complete -- a straggler batch still mid-decode never delays the
sample-queue push of a batch that finished, and a batch whose every
sequence hit EOS early stops paying for its remaining chunks
(``early_exit``).

Determinism: a job's key discipline is exactly ``generate()``'s (one
split per chunk from the per-batch key), its params are snapshotted at
admission, and skipped post-``early_exit`` chunks would only have written
PAD tokens with zero log-prob into an already PAD/zero-initialized
buffer -- so the chunk-scheduled path emits bit for bit the batches the
monolithic path emits.

The default priority is the batch index: the trainer consumes batches in
order, so the batch it needs soonest always advances first.  Pass a custom
``priority`` (e.g. most-finished-rows-first) for serving workloads with no
ordering constraint; see ``repro_torch.serve_partial_rollouts``.

``RowJob`` is the row-granular ticket of the continuous-batching engine.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.offpolicy import PartialRolloutCache
from repro_torch.obs import trace as obs_trace
from repro_torch.rl.rollout import RolloutState


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


class RolloutScheduler:
    """Drives ``rollout_chunk`` over a work heap of resumable jobs.

    The executor collaborator provides the two chunk-stepping hooks
    (``advance_chunk(job, state) -> state`` and
    ``emit_batch(job, state) -> batch``); the scheduler owns admission,
    ordering, parking and harvest.  ``chunk_delay(batch_index, chunk_idx)
    -> seconds`` injects straggler latency for benchmarks/tests.
    """

    def __init__(self, executor, cache: Optional[PartialRolloutCache] = None,
                 *, early_exit: bool = True,
                 chunk_delay: Optional[Callable[[int, int], float]] = None,
                 priority: Optional[Callable[[RolloutJob, RolloutState],
                                             Any]] = None):
        self.executor = executor
        self.cache = cache if cache is not None else PartialRolloutCache()
        self.early_exit = early_exit
        self.chunk_delay = chunk_delay
        self.priority = priority or (lambda job, state: job.batch_index)
        self._heap: list = []
        self._seq = 0              # heap tie-break; keeps admits FIFO-stable

    def admit(self, job: RolloutJob, state: RolloutState):
        """Park the freshly-prefilled state and enqueue the job."""
        obs_trace.instant("admit", "scheduler", batch=job.batch_index,
                          version=job.weight_version, bound=job.bound,
                          n_chunks=job.n_chunks)
        job.rid = self.cache.put(state)
        heapq.heappush(self._heap,
                       (self.priority(job, state), self._seq, job))
        self._seq += 1

    def pending(self) -> int:
        return len(self._heap)

    def inflight(self):
        """The parked in-flight jobs, heap order (the supervised
        re-admission surface: after a respawn every one of these gets a
        fresh params pin via ``repin_job``)."""
        return [job for _, _, job in self._heap]

    def _repark(self, prio, seq, job, state):
        """Put a job/state pair back exactly where it was popped from
        (original priority and FIFO tie-break)."""
        job.rid = self.cache.put(state)
        heapq.heappush(self._heap, (prio, seq, job))

    def step(self) -> Optional[Tuple[RolloutJob, Any]]:
        """Advance the highest-priority job one chunk.

        Returns ``(job, batch)`` the moment a batch's worth of sequences
        completes, else None (the job requeued with KV cache + cursor).
        If the executor hop fails (a process-backed actor died
        mid-chunk), the job and its resumable state are re-parked before
        the error re-raises -- nothing is lost, so a supervisor can
        re-admit the exact in-flight set on the respawned actor.
        """
        if not self._heap:
            return None
        prio, seq, job = heapq.heappop(self._heap)
        state = self.cache.get(job.rid)
        job.rid = None
        if self.chunk_delay is not None:
            dt = self.chunk_delay(job.batch_index, job.chunks_done)
            if dt and dt > 0:
                time.sleep(dt)     # injected straggler latency (counts busy)
        t0 = time.monotonic()
        finished = job.chunks_done >= job.n_chunks
        if not finished:
            try:
                with obs_trace.span("chunk", "scheduler",
                                    batch=job.batch_index,
                                    chunk=job.chunks_done):
                    state = self.executor.advance_chunk(job, state)
            except BaseException:
                job.busy_s += time.monotonic() - t0
                self._repark(prio, seq, job, state)
                raise
            finished = job.chunks_done >= job.n_chunks
            if not finished and self.early_exit:
                finished = bool(state.done.all())  # forces one device sync
        job.busy_s += time.monotonic() - t0
        if finished:
            t0 = time.monotonic()
            try:
                with obs_trace.span("emit", "scheduler",
                                    batch=job.batch_index,
                                    chunks=job.chunks_done):
                    batch = self.executor.emit_batch(job, state)
            except BaseException:
                job.busy_s += time.monotonic() - t0
                self._repark(prio, seq, job, state)
                raise
            job.busy_s += time.monotonic() - t0
            return job, batch
        job.rid = self.cache.put(state)
        heapq.heappush(self._heap,
                       (self.priority(job, state), self._seq, job))
        self._seq += 1
        return None

    def _release(self, job):
        """Best-effort release of executor-side resources (params pins)
        for a job dropped without emitting.  ``clear()`` also runs
        against *dead* actors (degraded mode), whose pins died with the
        process -- transport errors are swallowed."""
        rel = getattr(self.executor, "release_job", None)
        if rel is None:
            return
        try:
            rel(job)
        except Exception:
            pass

    def clear(self):
        """Drop every in-flight job, evicting its parked state and
        releasing its executor-side params pin; returns the dropped jobs
        (degraded mode: a lost worker's batches are re-generated from
        scratch by the survivors)."""
        jobs = []
        while self._heap:
            _, _, job = heapq.heappop(self._heap)
            if job.rid is not None:
                self.cache.get(job.rid)        # evict the parked state
                job.rid = None
            self._release(job)
            jobs.append(job)
        return jobs

    def drain(self):
        """Step until the heap is empty, yielding batches as they finish.

        A consumer that abandons the iteration mid-drain (early exit
        between chunks) used to leak the remaining jobs' parked states
        and executor-side ``PinnedParams``; now the leftovers are
        cleared -- states evicted, pins released -- on the way out."""
        try:
            while self._heap:
                done = self.step()
                if done is not None:
                    yield done
        finally:
            if self._heap:
                self.clear()
