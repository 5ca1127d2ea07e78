"""Single-controller RL loop, sequential part (paper Sec. 5.1.3,
Algorithm 1; the port of the JAX package's ``core/controller.py``).

``SyncExecutorController`` drives actor handles on one thread, in two
schedules matching Fig. 2:

  * mode="sync"  -- on-policy: generate -> score -> train, weights
    delivered fresh every tick (staleness 0).
  * mode="async" -- the bounded-staleness off-policy schedule with
    ``staleness >= 1``, run sequentially: batch ``n`` is generated with
    weights version ``max(0, n - staleness)`` and trained when the trainer
    has taken exactly ``n`` updates.  This is what the reference's
    ``AsyncExecutorController.run_sequential`` runs, the numerics its
    threaded controller must reproduce.

The threaded ``AsyncExecutorController`` needs the generator pool, the
weight fabric and supervision (ROADMAP A7-A9), so ``ExecutorController``
refuses mode="async" until then.  The reference's trace spans and
histograms (``repro.obs``) come with A9, and periodic checkpoints with
the checkpoint module (A12); ``history`` rows carry every other field the
reference records.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

from repro_torch.core.actors import ActorHandle, as_handle
from repro_torch.core.channels import CommType, CommunicationChannel
from repro_torch.core.offpolicy import StalenessBuffer


def ExecutorController(executor_group, communication_channels, max_steps,
                       mode: str = "async", **kwargs):
    """The controller for ``mode``: ``SyncExecutorController`` for "sync";
    "async" needs the threaded controller (ROADMAP A7-A9).  Its schedule
    runs on one thread as ``SyncExecutorController(mode="async")``."""
    if mode == "async":
        raise NotImplementedError(
            "the threaded AsyncExecutorController needs genpool, fabric and "
            "supervise (ROADMAP A7-A9); SyncExecutorController(mode='async')"
            " runs the same schedule on one thread")
    return SyncExecutorController(executor_group, communication_channels,
                                  max_steps, mode=mode, **kwargs)


class SyncExecutorController:
    """Sequential single-controller loop over actor handles."""

    def __init__(self, executor_group: List[ActorHandle],
                 communication_channels: List[CommunicationChannel],
                 max_steps: int, mode: str = "sync", staleness: int = 1):
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        handles = [as_handle(e) for e in executor_group]
        names = [h.name for h in handles]
        if len(names) != len(set(names)):
            raise ValueError(f"executor names must be unique, got {names}")
        self.executors: Dict[str, ActorHandle] = {h.name: h for h in handles}
        self.channels = communication_channels
        self.max_steps = max_steps
        self.mode = mode
        # sync mode is the on-policy baseline: weights delivered fresh
        self.staleness = max(1, staleness) if mode == "async" else 0
        self.history: List[Dict] = []
        self.stats: Dict[str, float] = {}
        self.staleness_hist: collections.Counter = collections.Counter()
        self.generators = [h for h in handles if h.role == "generator"]
        if len(self.generators) > 1:
            raise ValueError(
                "the sequential loop drives a single generator; a pool of "
                f"{len(self.generators)} needs the threaded controller "
                "(ROADMAP A7)")
        self.generator = self.generators[0] if self.generators else None
        self.trainer = next((h for h in handles if h.role == "trainer"), None)
        self._initialized = False
        self._tick = 0                       # trained steps == weight version
        self._weight_bufs: Dict[int, StalenessBuffer] = {}
        self._pushed_tick: Dict[int, int] = {}

    # ------------------------------------------------------------ plumbing --

    def _data_channels(self):
        return [c for c in self.channels
                if c.comm_type in (CommType.BROADCAST, CommType.SCATTER,
                                   CommType.GATHER)]

    def _weight_channels(self):
        return [c for c in self.channels if c.comm_type.is_weights]

    def _weight_buf(self, ch) -> StalenessBuffer:
        buf = self._weight_bufs.get(id(ch))
        if buf is None:
            buf = self._weight_bufs[id(ch)] = \
                StalenessBuffer(delay=self.staleness)
        return buf

    def _sync_weights(self, tick: int):
        """Push this tick's trainer weights as version ``tick`` and
        deliver what the StalenessBuffer releases: exactly version
        ``tick - staleness`` once tick >= staleness.  Idempotent per
        (channel, tick)."""
        for ch in self._weight_channels():
            if self._pushed_tick.get(id(ch), -1) >= tick:
                continue
            buf = self._weight_buf(ch)
            buf.push(tick, ch.outbound.call("get_output", ch.name))
            self._pushed_tick[id(ch)] = tick
            released = buf.pop()
            if released is not None:
                version, params = released
                ch.deliver(params, version=version)

    def _pipeline(self):
        """Walk data channels in declared order; each inbound actor steps
        right after its channel delivers (gen -> reward -> trainer ...)."""
        for ch in self._data_channels():
            ch.communicate()
            ch.inbound.call("step")

    def _record(self, step: int, step_time: float, *, weight_version: int,
                bound: Optional[int] = None):
        metrics = self.trainer.call("last_metrics") if self.trainer else {}
        bound = self.staleness if bound is None else bound
        sample_staleness = step - weight_version
        if sample_staleness > bound:
            raise RuntimeError(
                f"staleness bound violated at step {step}: batch weights "
                f"are version {weight_version}, bound {bound}")
        self.staleness_hist[sample_staleness] += 1
        metrics.update(step=step, step_time=step_time,
                       weight_version=weight_version,
                       trainer_version=step + 1,
                       sample_staleness=sample_staleness,
                       staleness_bound=bound,
                       generator=self.generator.name
                       if self.generator is not None else None,
                       queue_depth=0, gen_idle_s=0.0, train_idle_s=0.0)
        self.history.append(metrics)

    def init(self):
        if self._initialized:
            return
        for h in self.executors.values():
            h.call("init")
        # initial weights (version 0) go out with zero lag; the push seeds
        # each weight channel's StalenessBuffer for the delayed schedule
        for ch in self._weight_channels():
            params = ch.outbound.call("get_output", ch.name)
            buf = self._weight_buf(ch)
            buf.push(0, params)
            buf.pop()                       # delay=0 releases it; s>=1 keeps
            self._pushed_tick[id(ch)] = 0
            ch.deliver(params, version=0)
        self._initialized = True

    # ----------------------------------------------------- sequential loop --

    def run(self) -> List[Dict]:
        """Run ``max_steps`` (more) ticks; repeated calls continue."""
        self.init()
        gen = self.generator
        wall0 = time.monotonic()
        for _ in range(self.max_steps):
            step = self._tick
            t0 = time.perf_counter()
            for h in self.executors.values():
                h.call("set_step", step)
            if step > 0:
                self._sync_weights(step)
            if gen is not None:
                gen.call("step")
            self._pipeline()
            self._tick += 1
            wv = gen.call("weight_version") if gen is not None else step
            self._record(step, time.perf_counter() - t0, weight_version=wv)
        wall = time.monotonic() - wall0
        self.stats = {"wall_s": wall, "gen_busy_s": wall,
                      "train_busy_s": wall, "overlap_s": 0.0,
                      "gen_idle_s": 0.0, "train_idle_s": 0.0}
        return self.history
