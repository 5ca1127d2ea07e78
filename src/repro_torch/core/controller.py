"""Single-controller RL loop (paper Sec. 5.1.3, Algorithm 1; the port of
the JAX package's ``core/controller.py``).

The controller never touches an executor directly: every stage is an
``ActorHandle`` (``repro_torch.core.actors``) whose endpoints -- ``call``
for a synchronous endpoint, ``cast`` for fire-and-forget -- ride the
handle's transport; raw executors passed in are wrapped on the spot.

Two execution modes, matching Fig. 2:

  * mode="sync"  -- synchronous on-policy RL: generate -> score -> train,
    each stage blocking the next; weights synced every tick.
  * mode="async" -- asynchronous off-policy RL with real threads
    (``AsyncExecutorController``): a *pool* of generator actors (one
    worker thread each, batch indices interleaved round-robin) produces
    ``(weight_version, batch)`` pairs into a ``StalenessBuffer``; the
    reward/reference/trainer stages consume from it -- in batch order,
    reordering the fan-in -- on a consumer thread; the trainer publishes
    versioned weights back to every worker through the ``WeightFabric``
    and per-generator queue-backed ``WeightsCommunicationChannel``s.
    Inside each worker a chunk scheduler (``repro_torch.rl.scheduler``)
    resumes partial rollouts so a straggler batch never delays the
    admission of its successors; see ``repro_torch.core.genpool``.

``ExecutorController(...)`` is the single construction entry point: it
returns an ``AsyncExecutorController`` for mode="async" and the
sequential ``SyncExecutorController`` otherwise.

Bounded-staleness schedule (AIPO's assumption, paper Sec. 6): batch ``n``
is generated with weights version ``max(0, n - staleness)`` and trained
when the trainer has performed exactly ``n`` updates, so the trained
sample is never more than ``staleness`` versions behind.  Versions are
pinned *by count*, not by wall-clock arrival, which makes the threaded
controller -- at pool size 1 and a fixed bound -- bit for bit identical
to the sequential reference (``run_sequential``) at every staleness:
threading changes wall-clock overlap, never numerics.  Passing an
``AdaptiveStalenessController`` as ``adaptive`` lets the bound move
online between its ``min_bound`` and ``max_bound``.

On a GPU every thread of this process launches on the device's default
stream (no executor is given a stream of its own), so in-process
executors' kernels run in launch order on one queue: threads overlap
their host work (Python dispatch, under the GIL) with each other's device
work, never two executors' kernels with each other.  An actor behind a
process transport runs in its own child, with its own interpreter lock,
CUDA context and default stream.

``history`` records, per trained step: the trainer metrics plus
``weight_version`` (of the batch's generator weights), ``trainer_version``,
``sample_staleness``, ``staleness_bound`` (in effect at admission), the
producing ``generator``, ``queue_depth`` and per-executor idle time;
``stats`` aggregates wall-clock busy/idle/overlap per run and
``staleness_hist`` counts observed staleness values.

Shutdown is deterministic: worker and consumer threads are non-daemon,
and on completion, error or timeout the controller closes the sample
queue and channels so any blocked peer unwinds with ``Closed`` and joins;
a worker's exception re-raises on the calling thread.

``supervise=`` (``True``, a ``RestartPolicy`` or a ``Supervisor``) makes
the threaded loop survive a dead generator or reference actor: the pool's
workers recover their own generators (``repro_torch.core.genpool``), the
consumer recovers the reference and retries the batch, and the trainer
stays fail-fast, as in the reference.  ``checkpoint_every`` writes the
trainer's params to ``checkpoint_path`` every that many steps.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.actors import ActorDied, ActorHandle, as_handle
from repro_torch.core.channels import CommType, CommunicationChannel, \
    WeightsCommunicationChannel
from repro_torch.core.fabric import WeightFabric, payload_key
from repro_torch.core.genpool import AdaptiveStalenessController, \
    FixedStaleness, GeneratorPool, PoolConfig
from repro_torch.core.offpolicy import Closed, StalenessBuffer
from repro_torch.core.supervise import RESPAWNED, RestartPolicy, Supervisor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import IntervalUnion, interval_overlap


def _merge_intervals(ivs):
    """Union of possibly-overlapping intervals (pool workers run in
    parallel) as a sorted disjoint list."""
    merged = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


class _RunStats:
    """Live, incrementally aggregated source behind ``controller.stats``
    for a threaded run.

    The interval feeds (pool worker busy spans, consumer busy spans,
    fabric publish spans) stream into maintained ``IntervalUnion``s,
    scalar sums are carried incrementally, overlap results are cached
    against the unions' version counters, and the computed dict is
    cached against the feed lengths -- a poll with no new history rows is
    a dict copy."""

    def __init__(self, controller, pool, train_iv, publish_wait,
                 first: int, wall0: float, pub0: int):
        self._ctl = controller
        self._pool = pool
        self._train_iv = train_iv
        self._publish_wait = publish_wait
        self._first = first
        self._wall0 = wall0
        self._wall: Optional[float] = None   # set by finish()
        self._lock = threading.Lock()
        self._gen = IntervalUnion()
        self._train = IntervalUnion()
        self._pub = IntervalUnion()
        self._n_gen = 0
        self._n_train = 0
        self._n_pub = pub0                   # fabric intervals span runs
        self._n_wait = 0
        self._n_rows = first
        self._gen_worker_s = 0.0
        self._gen_idle_s = 0.0
        self._train_idle_s = 0.0
        self._publish_wait_s = 0.0
        self._overlaps: Dict[str, tuple] = {}
        self._key = None
        self._cached: Dict[str, float] = {}

    def finish(self, wall: float):
        with self._lock:
            self._wall = wall
            self._key = None                 # wall_s is now final

    def _overlap(self, name: str, a: IntervalUnion,
                 b: IntervalUnion) -> float:
        cached = self._overlaps.get(name)
        key = (a.version, b.version)
        if cached is not None and cached[0] == key:
            return cached[1]
        v = interval_overlap(a, b)
        self._overlaps[name] = (key, v)
        return v

    def compute(self) -> Dict[str, float]:
        ctl = self._ctl
        with self._lock:
            pool_iv = self._pool.intervals
            fab_iv = ctl._fabric.intervals
            history = ctl.history
            key = (len(pool_iv), len(self._train_iv), len(fab_iv),
                   len(self._publish_wait), len(history),
                   self._wall is not None)
            if key != self._key:
                # feed the new tail of every source (lists are append-
                # only; len() snapshots are safe against live writers)
                for s, e in pool_iv[self._n_gen:key[0]]:
                    self._gen.add(s, e)
                    self._gen_worker_s += e - s
                self._n_gen = key[0]
                for s, e in self._train_iv[self._n_train:key[1]]:
                    self._train.add(s, e)
                self._n_train = key[1]
                for s, e in fab_iv[self._n_pub:key[2]]:
                    self._pub.add(s, e)
                self._n_pub = key[2]
                for w in self._publish_wait[self._n_wait:key[3]]:
                    self._publish_wait_s += w
                self._n_wait = key[3]
                for row in history[self._n_rows:key[4]]:
                    self._gen_idle_s += row["gen_idle_s"]
                    self._train_idle_s += row["train_idle_s"]
                self._n_rows = key[4]
                self._cached = {
                    "wall_s": self._wall if self._wall is not None
                    else time.monotonic() - self._wall0,
                    # wall-clock with >= 1 worker busy (never exceeds
                    # wall_s) vs aggregate worker-seconds across the pool
                    "gen_busy_s": self._gen.total,
                    "gen_worker_s": self._gen_worker_s,
                    "train_busy_s": self._train.total,
                    "overlap_s": self._overlap("gt", self._gen,
                                               self._train),
                    "gen_idle_s": self._gen_idle_s,
                    "train_idle_s": self._train_idle_s,
                    # weight publication wall-clock, how much of it was
                    # hidden behind generation, and how long the
                    # consumer's hot path waited in publish()
                    "publish_s": self._pub.total,
                    "publish_overlap_s": self._overlap("gp", self._gen,
                                                       self._pub),
                    "publish_wait_s": self._publish_wait_s,
                }
                self._key = key
            out = dict(self._cached)
            if self._wall is None:           # live poll: wall is now
                out["wall_s"] = time.monotonic() - self._wall0
            return out


def ExecutorController(executor_group, communication_channels, max_steps,
                       mode: str = "async", **kwargs):
    """Build the controller for ``mode``: the threaded
    ``AsyncExecutorController`` for "async", the sequential
    ``SyncExecutorController`` for "sync".  All validation happens in the
    class initializers it delegates to."""
    cls = AsyncExecutorController if mode == "async" \
        else SyncExecutorController
    return cls(executor_group, communication_channels, max_steps,
               mode=mode, **kwargs)


class SyncExecutorController:
    """Sequential single-controller loop over actor handles (also the
    base class providing the plumbing the threaded subclass shares)."""

    def __init__(self, executor_group: List[ActorHandle],
                 communication_channels: List[CommunicationChannel],
                 max_steps: int, mode: str = "sync", staleness: int = 1,
                 checkpoint_every: int = 0, checkpoint_path: str = "",
                 timeout: float = 600.0,
                 pool: Optional[PoolConfig] = None,
                 adaptive: Optional[AdaptiveStalenessController] = None,
                 overlap_publish: bool = True,
                 supervise=None):
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        # supervise: None/False = fail-fast; True = a Supervisor with the
        # default RestartPolicy; a RestartPolicy or a Supervisor as given
        if supervise is True:
            supervise = Supervisor()
        elif isinstance(supervise, RestartPolicy):
            supervise = Supervisor(supervise)
        self.supervisor: Optional[Supervisor] = supervise or None
        handles = [as_handle(e) for e in executor_group]
        names = [h.name for h in handles]
        if len(names) != len(set(names)):
            raise ValueError(f"executor names must be unique, got {names} "
                             "(pool generators need explicit name= "
                             "arguments)")
        self.executors: Dict[str, ActorHandle] = {h.name: h for h in handles}
        self.channels = communication_channels
        self.max_steps = max_steps
        self.mode = mode
        # sync mode is the on-policy baseline: weights delivered fresh
        self.staleness = max(1, staleness) if mode == "async" else 0
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self.timeout = timeout
        self.pool_config = pool
        self.adaptive = adaptive
        self.overlap_publish = overlap_publish
        self.history: List[Dict] = []
        self.stats = {}
        self.staleness_hist: collections.Counter = collections.Counter()
        self.generators = [h for h in handles if h.role == "generator"]
        self.generator = self.generators[0] if self.generators else None
        self.trainer = next((h for h in handles if h.role == "trainer"), None)
        self._initialized = False
        self._tick = 0                       # trained steps == weight version
        self._weight_bufs: Dict[int, StalenessBuffer] = {}
        self._pushed_tick: Dict[int, int] = {}

    # ------------------------------------------------------------ plumbing --

    @property
    def stats(self) -> Dict[str, float]:
        """Run aggregates (busy/idle/overlap wall-clock).  A threaded run
        serves them from a live ``_RunStats`` source, safe to poll every
        step; the sequential path keeps a plain dict."""
        src = self._stats_src
        if src is not None:
            return src.compute()
        return self._stats

    @stats.setter
    def stats(self, value: Dict[str, float]):
        self._stats = dict(value)
        self._stats_src = None

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

    def _sync_weights(self, tick: int, channels=None):
        """Push this tick's trainer weights as version ``tick`` and
        deliver what the StalenessBuffer releases: exactly version
        ``tick - staleness`` once tick >= staleness.  Idempotent per
        (channel, tick), so a supervised retry of a failed pipeline stage
        never pushes a version twice; a delivery lost with the inbound
        actor is replayed by the supervisor from its recorded seed."""
        for ch in (channels if channels is not None
                   else self._weight_channels()):
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
            with obs_trace.span(ch.inbound.role, "controller"):
                ch.communicate()
                ch.inbound.call("step")

    def _record(self, step: int, step_time: float, *, weight_version: int,
                queue_depth: int = 0, gen_idle_s: float = 0.0,
                train_idle_s: float = 0.0, bound: Optional[int] = None,
                generator: Optional[str] = None):
        metrics = self.trainer.call("last_metrics") if self.trainer else {}
        bound = self.staleness if bound is None else bound
        sample_staleness = step - weight_version
        if sample_staleness > bound:
            raise RuntimeError(
                f"staleness bound violated at step {step}: batch weights "
                f"are version {weight_version}, bound {bound}")
        self.staleness_hist[sample_staleness] += 1
        if generator is None and self.generator is not None:
            generator = self.generator.name
        metrics.update(step=step, step_time=step_time,
                       weight_version=weight_version,
                       trainer_version=step + 1,
                       sample_staleness=sample_staleness,
                       staleness_bound=bound, generator=generator,
                       queue_depth=queue_depth, gen_idle_s=gen_idle_s,
                       train_idle_s=train_idle_s,
                       # the trace's clock base: one timeline for the
                       # history rows and the trace events
                       t=obs_trace.now())
        obs_metrics.registry().histogram(
            "controller.batch_s").observe(step_time)
        self.history.append(metrics)

    def _maybe_checkpoint(self, step: int):
        """Every ``checkpoint_every`` steps, each stage's
        ``save_checkpoint`` (the trainer writes ``{name}_{step}``).  Pool
        generators hold nothing to save and are skipped: their handles
        belong to their workers, which may be respawning one."""
        if self.checkpoint_every and (step + 1) % self.checkpoint_every == 0:
            for h in self.executors.values():
                if h.role != "generator":
                    h.call("save_checkpoint", self.checkpoint_path, step)

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
        if len(self.generators) > 1:
            raise ValueError(
                "the sequential loop drives a single generator; a pool of "
                f"{len(self.generators)} needs mode='async' threads")
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
                with obs_trace.span("generate", "controller", batch=step):
                    gen.call("step")
            self._pipeline()
            self._tick += 1
            wv = gen.call("weight_version") if gen is not None else step
            self._record(step, time.perf_counter() - t0, weight_version=wv)
            self._maybe_checkpoint(step)
        wall = time.monotonic() - wall0
        self.stats = {"wall_s": wall, "gen_busy_s": wall,
                      "train_busy_s": wall, "overlap_s": 0.0,
                      "gen_idle_s": 0.0, "train_idle_s": 0.0}
        return self.history


class AsyncExecutorController(SyncExecutorController):
    """Threaded asynchronous controller (the paper's Fig. 2b).

    Producer side: a ``GeneratorPool`` of worker threads (one per
    generator actor; batch indices interleaved round-robin), each waiting
    for the pinned weight version, chunk-scheduling its rollouts and
    pushing ``(version, batch)`` into the sample ``StalenessBuffer`` the
    moment a batch completes.  Consumer thread: pops (reordering the
    multi-producer fan-in back into batch order), drives the
    reward/reference/trainer pipeline, publishes weights version ``n+1``
    to every worker's channel through the ``WeightFabric``, and feeds
    queue-depth observations to the staleness-bounds policy.  Exceptions
    on any thread stop and unwind the others (via ``shutdown()``) and
    re-raise in the caller; ``timeout`` bounds every blocking wait.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.mode != "async":
            raise ValueError("AsyncExecutorController runs mode='async'")
        if not self.generators or self.trainer is None:
            raise ValueError(
                "the async controller needs a generator and a trainer")
        self._bounds = self.adaptive if self.adaptive is not None \
            else FixedStaleness(self.staleness)
        max_bound = self._bounds.max_bound
        n_gens = len(self.generators)
        self._sample_queue = StalenessBuffer(
            delay=0, max_size=max_bound + n_gens + 2)
        self._live_weight_channels = [
            ch for ch in self._weight_channels()
            if ch.inbound in self.generators]
        self._channels_by_gen = {
            gen.name: [ch for ch in self._live_weight_channels
                       if ch.inbound is gen]
            for gen in self.generators}
        for gen in self.generators:
            if not self._channels_by_gen[gen.name]:
                raise ValueError(f"the async controller needs a weight "
                                 f"channel into generator '{gen.name}'")
        # weight channels that feed other executors (the frozen
        # reference) are serviced by the consumer thread on the same
        # delayed schedule as the sequential path
        self._aux_weight_channels = [
            ch for ch in self._weight_channels()
            if ch.inbound not in self.generators]
        for ch in self._live_weight_channels:
            # every channel carries every version; the schedule keeps the
            # in-flight window below 2*bound + pool size
            ch.resize(max(ch.capacity, 2 * max_bound + n_gens + 4))
        # the consumer snapshots the trainer port synchronously (so a
        # later step can never leak into a version) and hands
        # publication to the fabric's publisher thread, overlapped with
        # ongoing generation
        self._fabric = WeightFabric(
            self._live_weight_channels, overlap=self.overlap_publish,
            max_staged=2 * max_bound + n_gens + 4, timeout=self.timeout)
        self._pool: Optional[GeneratorPool] = None
        if self.supervisor is not None:
            self.supervisor.attach_fabric(self._fabric, self._bounds)
            for gen in self.generators:
                self.supervisor.register(
                    gen, channels=self._channels_by_gen[gen.name])
            # the fabric's publish loop is a chaos injection site too
            self._fabric.chaos = self.supervisor.chaos

    # The sequential reference: identical schedule, identical numerics, one
    # thread, no overlap.  Used to verify the threaded path bit for bit.
    def run_sequential(self) -> List[Dict]:
        self._claim_entry_point("sequential")
        return SyncExecutorController.run(self)

    def init(self):
        if self._initialized:
            return
        super().init()
        # init() delivers version 0 directly, so the fabric never sees
        # it: seed its replay source for a generator attached, or
        # respawned, before the first publish
        payloads: Dict[tuple, object] = {}
        for ch in self._live_weight_channels:
            key = payload_key(ch)
            if key not in payloads:
                payloads[key] = ch.outbound.call("get_output", ch.name)
        self._fabric.seed(0, payloads)
        if self.supervisor is not None:
            # non-generator weight consumers (the frozen reference) are
            # replayed from their recorded version-0 seed, not from the
            # fabric: only their first sync ever sticks
            by_actor: Dict[str, list] = {}
            for ch in self._aux_weight_channels:
                if ch.inbound.role not in ("generator", "trainer"):
                    by_actor.setdefault(ch.inbound.name, []).append(ch)
            for chs in by_actor.values():
                h = chs[0].inbound
                if self.supervisor.covers(h):
                    continue
                key = payload_key(chs[0])     # the fabric's copy, if ours
                seed = payloads[key] if key in payloads else \
                    chs[0].outbound.call("get_output", chs[0].name)
                self.supervisor.register(h, channels=chs,
                                         seed_weights=(0, seed))

    def shutdown(self):
        """Close the sample queue, all channels and the weight fabric:
        every blocked thread unwinds with ``Closed``.  Idempotent; the
        controller cannot run again afterwards."""
        self._sample_queue.close()
        for ch in self.channels:
            ch.close()
        self._fabric.close()

    def _claim_entry_point(self, which: str):
        """Threaded and sequential runs keep weight state in different
        places (channel queues vs tick buffers); continuing one with the
        other would deliver retired versions.  One controller, one mode."""
        claimed = getattr(self, "_entry_point", None)
        if claimed is not None and claimed != which:
            raise RuntimeError(
                f"cannot continue a '{claimed}' controller with a "
                f"'{which}' run; build a fresh controller instead")
        self._entry_point = which

    # ------------------------------------------------------------- threads --

    def _await(self, blocking_call, stop: threading.Event, what: str):
        """Run a blocking call in short slices so a peer failure (stop set)
        interrupts the wait; enforce the controller deadline."""
        deadline = time.monotonic() + self.timeout
        while not stop.is_set():
            try:
                return blocking_call(0.1)
            except (TimeoutError, queue.Empty):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"deadline ({self.timeout}s) waiting for {what}")
        return None

    def _pool_data_channels(self):
        """Data channels whose payloads travel by snapshot: any channel
        declared outbound from a pool generator serves the whole pool."""
        return [ch for ch in self._data_channels()
                if ch.outbound in self.generators]

    def _consumer_loop(self, first: int, last: int, stop: threading.Event,
                       intervals: list, publish_wait: list):
        others = [h for h in self.executors.values()
                  if h not in self.generators]
        pool_chs = self._pool_data_channels()
        chaos = self.supervisor.chaos if self.supervisor is not None else None
        pending: Dict[int, tuple] = {}       # out-of-order fan-in reorder
        for n in range(first, last):
            t0 = time.monotonic()
            with obs_trace.span("harvest-wait", "controller", batch=n):
                while n not in pending:
                    got = self._await(
                        lambda t: self._sample_queue.pop_wait(t),
                        stop, f"batch {n} from generator pool")
                    if got is None:
                        return
                    version, item = got
                    pending[item["batch_index"]] = (version, item)
            wait = time.monotonic() - t0
            version, item = pending.pop(n)
            depth = len(self._sample_queue) + len(pending)
            if chaos is not None:
                chaos.fire_any("consume", n)
            t0 = time.perf_counter()
            busy0 = time.monotonic()
            # the per-batch pipeline retries around a supervised actor's
            # death: set_step is idempotent, _sync_weights guards its
            # tick, and the scoring stages recompute the same outputs
            # from the same inputs; the trainer's update is the last hop,
            # so any failure recovered here happened before it
            while True:
                try:
                    for h in others:
                        h.call("set_step", n)
                    if n > 0:
                        # non-generator weight consumers get the same
                        # delayed delivery the sequential path gives them
                        self._sync_weights(
                            n, channels=self._aux_weight_channels)
                    for ch in self._data_channels():
                        # one span per pipeline hop, named by the stage
                        # it feeds (reward / reference / trainer)
                        with obs_trace.span(ch.inbound.role, "controller",
                                            batch=n):
                            if ch in pool_chs:
                                ch.deliver(item["snapshot"][ch.name])
                            else:
                                ch.communicate()
                            ch.inbound.call("step")
                    break
                except (ActorDied, TimeoutError) as e:
                    if not self._recover_consumer_actor(e):
                        raise
            # weight publication goes to the fabric: snapshot the source
            # port *now* (the next trainer step must not leak into version
            # n+1), then let the publisher thread run the transfer
            # overlapped with ongoing generation
            payloads: Dict[tuple, object] = {}
            for ch in self._live_weight_channels:
                key = payload_key(ch)
                if key not in payloads:
                    payloads[key] = ch.outbound.call("get_output", ch.name)
            tp0 = time.perf_counter()
            with obs_trace.span("publish-wait", "controller", batch=n):
                self._fabric.publish(n + 1, payloads)
            publish_wait.append(time.perf_counter() - tp0)
            self._tick = n + 1
            self._bounds.observe(queue_depth=depth, train_idle_s=wait,
                                 sample_staleness=n - version)
            busy1 = time.monotonic()
            intervals.append((busy0, busy1))
            # the consumer's whole busy region for this batch, on the
            # trace epoch (source of the summary's p50/p99 latency)
            obs_trace.complete("batch", "controller",
                               busy0 - obs_trace.epoch(),
                               busy1 - obs_trace.epoch(), batch=n,
                               weight_version=version, queue_depth=depth)
            self._record(n, time.perf_counter() - t0, weight_version=version,
                         queue_depth=depth, bound=item.get("bound"),
                         generator=item.get("generator"),
                         gen_idle_s=item["gen_idle_s"], train_idle_s=wait)
            self._maybe_checkpoint(n)

    def _recover_consumer_actor(self, error: BaseException) -> bool:
        """A consumer-side pipeline hop failed: find the supervised
        non-generator actor that died and recover it.  False (retrying is
        hopeless) when unsupervised, when nothing covered died, or when
        the restart budget is gone: the reward and reference stages are
        essential, so a lost one fails the run."""
        sup = self.supervisor
        if sup is None or not isinstance(error, ActorDied):
            return False
        for h in self.executors.values():
            if h.role in ("generator", "trainer"):
                continue            # pool workers recover their own; the
            if sup.covers(h) and not h.healthy():  # trainer is fail-fast
                return sup.recover(h, error) == RESPAWNED
        return False

    # ------------------------------------------------------ elastic resize --

    def attach_generator(self, spec) -> ActorHandle:
        """Grow the pool mid-run: spawn a generator from ``spec`` (a
        ``SpawnSpec``) or adopt an ``ActorHandle``, wire a weight channel,
        replay the latest published weights, and hand it a worker
        thread."""
        handle = spec if isinstance(spec, ActorHandle) else spec.spawn()
        if handle.role != "generator":
            raise ValueError(f"attach_generator got role '{handle.role}'")
        if handle.name in self.executors:
            raise ValueError(f"actor name '{handle.name}' already "
                             "registered")
        if self._pool is None:
            raise RuntimeError("attach_generator requires a live run")
        template = self._live_weight_channels[0]
        ch = WeightsCommunicationChannel(template.name, self.trainer, handle,
                                         comm_type=template.comm_type)
        ch.resize(template.capacity)
        self.executors[handle.name] = handle
        self.generators.append(handle)
        self._channels_by_gen[handle.name] = [ch]
        self._live_weight_channels.append(ch)
        self.channels.append(ch)
        handle.call("init")
        if self.supervisor is not None:
            self.supervisor.register(handle, channels=[ch])
        # subscribe + replay the latest version so the newcomer is
        # admission-legal before the next publish
        self._fabric.add_subscriber(ch)
        self._pool.attach(handle, [ch])
        return handle

    def detach_generator(self, name: str):
        """Shrink the pool mid-run: stop publishing to ``name``, drain
        its queued weight versions, and remap its unstarted batches to
        the other workers.  The handle stays registered."""
        if self._pool is None:
            raise RuntimeError("detach_generator requires a live run")
        for ch in self._channels_by_gen.get(name, []):
            self._fabric.detach(ch)
            ch.drain()
        return self._pool.detach(name)

    def run(self) -> List[Dict]:
        """Run ``max_steps`` (more) threaded steps; repeated calls continue
        (counters, channel queues and executor state persist)."""
        self._claim_entry_point("threaded")
        self.init()
        first, last = self._tick, self._tick + self.max_steps
        stop = threading.Event()
        errors: List[BaseException] = []
        train_iv: list = []
        publish_wait: list = []
        pool = GeneratorPool(
            self.generators, self._channels_by_gen,
            self._pool_data_channels(), self._sample_queue, self._bounds,
            config=self.pool_config, timeout=self.timeout,
            await_fn=self._await, supervisor=self.supervisor)
        self._pool = pool

        def guarded(fn, *args):
            def body():
                try:
                    fn(*args)
                except Closed:
                    pass                     # shutdown signal, not an error
                except BaseException as e:   # propagate to the caller
                    errors.append(e)
                    stop.set()
                    self.shutdown()          # wake peers blocked in comms
            return body

        # dynamic thread registry: attach_generator() may add workers
        # mid-run, so the join loop re-snapshots until nothing is alive
        # *and* nothing new appeared
        threads: List[threading.Thread] = []
        threads_lock = threading.Lock()

        def spawn_thread(name, loop):
            t = threading.Thread(target=guarded(loop), name=name)
            with threads_lock:
                threads.append(t)
            t.start()
            return t

        pool._spawn_thread = spawn_thread
        wall0 = time.monotonic()
        pub0 = len(self._fabric.intervals)
        # stats go live now: polls during the run see the partial
        # aggregates, incrementally maintained
        self._stats_src = _RunStats(self, pool, train_iv, publish_wait,
                                    first, wall0, pub0)
        for name, loop in pool.loops(first, last, stop):
            spawn_thread(name, loop)
        spawn_thread("consumer",
                     lambda: self._consumer_loop(first, last, stop,
                                                 train_iv, publish_wait))
        deadline = time.monotonic() + self.timeout
        stragglers: List[threading.Thread] = []
        while True:
            with threads_lock:
                snapshot = list(threads)
            for t in snapshot:
                t.join(timeout=0.2)
            alive = [t for t in snapshot if t.is_alive()]
            with threads_lock:
                grown = len(threads) > len(snapshot)
            if not alive and not grown:
                break
            if time.monotonic() > deadline:
                stragglers = alive
                break
        if stragglers:
            stop.set()
            self.shutdown()                  # unblock and join stragglers
            for t in stragglers:
                t.join(timeout=5.0)
            if not errors:
                raise TimeoutError(
                    f"controller deadline ({self.timeout}s) exceeded; "
                    "executor threads did not finish")
        if errors:
            self.shutdown()
            raise errors[0]
        try:
            # drain in-flight publications, then park the publisher
            # thread so nothing outlives this run (the fabric restarts
            # it on the next run's first publish)
            self._fabric.flush(self.timeout)
        except BaseException:
            self.shutdown()
            raise
        finally:
            self._fabric.quiesce()
        wall = time.monotonic() - wall0
        self._stats_src.finish(wall)
        return self.history
