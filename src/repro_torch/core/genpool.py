"""Generator pool: multi-generator fan-in with partial-rollout chunk
scheduling, adaptive staleness and supervised recovery (the port of the
JAX package's ``core/genpool.py``).

The paper's headline speed-up comes from overlapping generation with
training (Fig. 2) and from partial rollouts that keep stragglers from
stalling the sample queue (Sec. 4.2).  This module supplies both on top of
the threaded controller:

  * ``GeneratorPool`` -- N generator workers, one thread each, every
    worker owning one ``GeneratorExecutor`` and its own versioned weight
    channel(s), all fanning into the single bounded ``StalenessBuffer``
    sample queue the reward/ref/trainer consumer drains.  Batch indices
    are interleaved round-robin (worker ``i`` handles batches
    ``i, i+N, i+2N, ...``), and each worker admits batch ``n`` only once
    its executor holds weight version ``max(0, n - bound)`` -- so a pool
    of size 1 at a fixed bound reproduces the sequential schedule
    bit for bit, and a larger pool only adds wall-clock overlap.

  * chunk scheduling -- inside each worker a ``RolloutScheduler`` drives
    ``rollout_chunk`` over a work heap of resumable ``RolloutState``s
    (parked in a thread-safe ``PartialRolloutCache``): finished batches
    are pushed the moment they complete, incomplete ones requeue with
    their KV cache and cursor, and up to ``max_inflight`` batches
    pipeline inside one worker so a straggler never delays the admission
    of its successors.  ``PoolConfig(engine=True)`` runs the
    continuous-batching engine instead (``repro_torch.rl.engine``).

  * ``AdaptiveStalenessController`` -- reads the queue depths and idle
    times the consumer records into ``history`` and widens or narrows the
    staleness bound online: a starved trainer buys throughput with a
    wider bound; a backlogged queue narrows it back toward on-policy.

Workers drive their generator through an ``ActorHandle``.  An
in-process generator computes on its worker's thread, sharing the
interpreter lock and, on a GPU, the default stream with the other workers
and the consumer; a generator behind a process transport (``proc``,
``shm``, ``socket``) computes in its own child, with its own lock, CUDA
context and stream, and pins each job's params on its side.

Unsupervised, a worker's exception -- ``ActorDied`` included -- stops the
run.  With a ``Supervisor`` (``repro_torch.core.supervise``) a worker
whose generator died or hung hands it to ``Supervisor.recover``: a
respawned generator gets the latest weights replayed, the worker re-pins
its in-flight jobs (the engine re-enqueues its batches) and retries the
batch it was on; a generator declared lost has its unfinished batches
failed over to the surviving workers (``WorkAssignment.fail_over``).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.actors import ActorDied, spawn_actor, spawn_all
from repro_torch.core.offpolicy import PartialRolloutCache, StalenessBuffer
from repro_torch.core.supervise import LOST, RESPAWNED
from repro_torch.obs import trace as obs_trace
from repro_torch.rl.scheduler import RolloutScheduler


def build_generator_pool(cfg, trainer, make_tasks, *, n_generators=1,
                         generator_cls=None, name="generator", seed=0,
                         weight_port="policy_model", transport=None,
                         device_spec=None, addresses=None,
                         call_timeout=600.0, **gen_kwargs):
    """The pool wiring convention, in one place: N generator actors
    (worker ``g`` named ``{name}{g}`` and seeded ``seed + g``; a pool of
    one keeps the bare ``name``) plus one versioned weight channel from
    the trainer into each.  ``make_tasks(g)`` builds worker ``g``'s task
    source (in this process; what it returns must pickle for a remote
    transport).  ``transport`` picks the placement of every generator
    ("inproc", "proc", "shm" or "socket"; None reads
    ``REPRO_TRANSPORT``).  ``device_spec`` gives each spawned generator
    its cards: one ``DeviceSpec`` for all, or a callable ``g -> spec``;
    ``addresses`` (socket transport) assigns worker ``g`` the ``g``-th
    ``--listen`` host, self-hosting any worker beyond the list.  Remote
    workers spawn at once, each on a thread of its own (a child takes
    seconds to import torch and open its CUDA context); in-process ones
    are built in order.  Returns ``(generator_handles,
    weight_channels)``, worker ``g`` at ``g`` (no weight channel when
    ``trainer`` is None: the caller wires them once its trainer is up);
    the caller declares data channels outbound from ``generators[0]`` --
    they serve the whole pool through per-item snapshots.
    """
    from repro_torch.core.channels import WeightsCommunicationChannel
    from repro_torch.core.executor import GeneratorExecutor
    generator_cls = generator_cls or GeneratorExecutor
    workers = [(g, make_tasks(g),
                device_spec(g) if callable(device_spec) else device_spec,
                addresses[g] if addresses and g < len(addresses) else None)
               for g in range(n_generators)]

    def spawn(worker):
        g, tasks, spec, addr = worker
        return spawn_actor(
            generator_cls, cfg, tasks, seed=seed + g,
            name=name if n_generators == 1 else f"{name}{g}",
            transport=transport, device_spec=spec, address=addr,
            call_timeout=call_timeout, **gen_kwargs)

    remote = (transport or os.environ.get("REPRO_TRANSPORT", "inproc")) \
        != "inproc"
    gens = spawn_all([functools.partial(spawn, w) for w in workers],
                     at_once=remote and n_generators > 1)
    chans = [WeightsCommunicationChannel(weight_port, trainer, gen)
             for gen in gens] if trainer is not None else []
    return gens, chans


# ------------------------------------------------------- staleness bounds --

class FixedStaleness:
    """The static bound: ``bound()`` never moves, ``observe`` is a no-op."""

    def __init__(self, bound: int):
        self._bound = max(0, int(bound))
        self.bound_history: List[int] = []

    def bound(self) -> int:
        return self._bound

    @property
    def max_bound(self) -> int:
        return self._bound

    def observe(self, **kwargs):
        pass

    def on_pool_resize(self, n_workers: int):
        """Membership changed; a fixed bound stays fixed."""


class AdaptiveStalenessController:
    """Widens/narrows the staleness bound online from queue observations.

    The consumer thread calls ``observe`` once per trained batch with the
    sample-queue depth it saw and how long it waited (the same numbers it
    records into ``history``).  Every ``window`` observations the bound is
    re-decided:

      * starved in >= ``widen_frac`` of the window (depth 0 *and* the
        trainer measurably waited on generation) -> widen by one, up to
        ``max_bound`` -- staler samples are the price of keeping the
        trainer busy;
      * starved in <= ``narrow_frac`` of the window (the queue had a
        batch ready, or delivery was just-in-time) -> narrow by one, down
        to ``min_bound`` -- the pool is keeping up, so tighten back
        toward on-policy.

    A just-in-time pipeline (queue drained to zero after every pop but
    the trainer never waiting) therefore reads as *keeping up*, not
    starved -- ``idle_eps_s`` is the wait below which the trainer counts
    as fed.

    Thread-safe: workers read ``bound()`` while the consumer observes.
    ``bound_history`` logs the bound after every observation (what the
    example prints and tests assert on).
    """

    def __init__(self, bound: int = 1, *, min_bound: int = 1,
                 max_bound: int = 4, window: int = 4,
                 widen_frac: float = 0.75, narrow_frac: float = 0.25,
                 idle_eps_s: float = 1e-3):
        if not 1 <= min_bound <= max_bound:
            raise ValueError(f"need 1 <= min_bound <= max_bound, got "
                             f"{min_bound}, {max_bound}")
        if not 0.0 <= narrow_frac < widen_frac <= 1.0:
            raise ValueError(f"need 0 <= narrow_frac < widen_frac <= 1, "
                             f"got {narrow_frac}, {widen_frac}")
        self.min_bound, self.max_bound = int(min_bound), int(max_bound)
        self.window = max(1, int(window))
        self.widen_frac, self.narrow_frac = widen_frac, narrow_frac
        self.idle_eps_s = idle_eps_s
        self._bound = min(self.max_bound, max(self.min_bound, int(bound)))
        self._starved: collections.deque = collections.deque(
            maxlen=self.window)
        self._lock = threading.Lock()
        self.bound_history: List[int] = []

    def bound(self) -> int:
        with self._lock:
            return self._bound

    def observe(self, *, queue_depth: int, train_idle_s: float = 0.0,
                sample_staleness: int = 0, **_):
        """One consumer-side observation; re-decides on a full window."""
        with self._lock:
            self._starved.append(1 if queue_depth <= 0
                                 and train_idle_s > self.idle_eps_s else 0)
            if len(self._starved) == self.window:
                starved_frac = sum(self._starved) / self.window
                if starved_frac >= self.widen_frac and \
                        self._bound < self.max_bound:
                    self._bound += 1
                    self._starved.clear()
                elif starved_frac <= self.narrow_frac and \
                        self._bound > self.min_bound:
                    self._bound -= 1
                    self._starved.clear()
            self.bound_history.append(self._bound)

    def on_pool_resize(self, n_workers: int):
        """Pool membership changed (a worker lost, runtime attach/detach):
        the starvation
        window describes a pool that no longer exists, so drop it and
        re-tune from fresh observations."""
        with self._lock:
            self._starved.clear()


class _SnapshotEmitter:
    """Scheduler collaborator over an ``ActorHandle`` that fuses harvest
    and port snapshot into one endpoint: ``emit_batch`` returns the
    ``{channel name: output}`` snapshot the worker pushes."""

    def __init__(self, gen, names, chaos=None):
        self._gen = gen
        self._names = list(names)
        self._chaos = chaos

    def advance_chunk(self, job, state):
        if self._chaos is not None:
            # mid-decode injection point: "batch=N,chunk=C" faults fire
            # here, right before chunk C of batch N advances
            self._chaos.fire("batch", self._gen.name, job.batch_index,
                             job.chunks_done)
        return self._gen.advance_chunk(job, state)

    def emit_batch(self, job, state):
        return self._gen.call("emit_batch_snapshot", job, state,
                              self._names)


# ----------------------------------------------------------- work mapping --

class WorkAssignment:
    """Thread-safe batch-index ownership for the pool.

    Initialized round-robin -- worker ``i`` owns ``first+i, first+i+N,
    ...`` -- which is exactly the schedule the static loops produce, so
    pool-of-1 equivalence holds.  Membership changes re-deal indices:

      * ``fail_over(name)`` -- a worker was declared lost: its queued
        *and* in-flight (started, unfinished) indices go to the survivors;
      * ``add_worker`` / ``drain_worker`` + ``rebalance`` -- runtime
        grow/shrink: unstarted indices re-dealt round-robin over the
        current members; a draining worker finishes its in-flight jobs
        but receives nothing new.

    Each worker's queue stays sorted ascending: a queue head is its
    worker's smallest unadmitted index and every smaller index is owned
    elsewhere, so the bounded-staleness admission gate always eventually
    opens.  Workers exit only when ``all_done()`` (or they are retired and
    drained): a worker that emptied its own queue parks briefly instead,
    because a peer's loss or a rebalance may deal indices onto it.
    """

    def __init__(self, names: List[str], first: int, last: int):
        self._lock = threading.Lock()
        n = len(names)
        self._todo: Dict[str, collections.deque] = {
            name: collections.deque(range(first + i, last, n))
            for i, name in enumerate(names)}
        self._active: Dict[str, set] = {name: set() for name in names}
        self._retired: set = set()

    # ------------------------------------------------------- worker surface --

    def next_for(self, name: str) -> Optional[int]:
        """Peek this worker's next index (None = personal queue empty)."""
        with self._lock:
            q = self._todo.get(name)
            return q[0] if q else None

    def start(self, name: str, n: int) -> bool:
        """Atomically claim ``n`` for production.  False means a
        concurrent rebalance or drain re-dealt it to another worker
        between this worker's peek and now -- the caller drops it and
        re-peeks, or two workers would produce it."""
        with self._lock:
            try:
                self._todo[name].remove(n)
            except ValueError:
                return False
            self._active[name].add(n)
            return True

    def requeue(self, name: str, n: int):
        """Un-claim ``n`` (its production died before completing but the
        worker respawned): back into this worker's queue for a retry."""
        with self._lock:
            self._active[name].discard(n)
            q = self._todo[name]
            q.append(n)
            self._todo[name] = collections.deque(sorted(q))

    def finish(self, name: str, n: int):
        with self._lock:
            self._active[name].discard(n)

    def all_done(self) -> bool:
        with self._lock:
            return not any(self._todo.values()) \
                and not any(self._active.values())

    def is_retired(self, name: str) -> bool:
        with self._lock:
            return name in self._retired

    def idle(self, name: str) -> bool:
        """Retired-and-drained: this worker's thread may exit early."""
        with self._lock:
            return name in self._retired and not self._todo.get(name) \
                and not self._active.get(name)

    # ---------------------------------------------------------- membership --

    def survivors(self) -> List[str]:
        with self._lock:
            return self._survivors_locked()

    def _survivors_locked(self) -> List[str]:
        return [k for k in self._todo if k not in self._retired]

    def _deal_locked(self, indices, names):
        todo = self._todo                    # caller holds self._lock
        for j, n in enumerate(sorted(indices)):
            todo[names[j % len(names)]].append(n)
        for k in names:
            todo[k] = collections.deque(sorted(todo[k]))

    def fail_over(self, name: str) -> List[int]:
        """Redistribute a lost worker's unfinished indices over the
        survivors; raises ``RuntimeError`` when none remain (the caller
        falls back to fail-fast)."""
        with self._lock:
            moved = sorted(set(self._todo.get(name, ())) |
                           self._active.get(name, set()))
            survivors = [k for k in self._survivors_locked() if k != name]
            if not survivors:
                raise RuntimeError(
                    f"no surviving workers to take over for '{name}'")
            self._todo[name] = collections.deque()
            self._active[name] = set()
            self._retired.add(name)
            self._deal_locked(moved, survivors)
            return moved

    def add_worker(self, name: str):
        with self._lock:
            self._todo.setdefault(name, collections.deque())
            self._active.setdefault(name, set())
            self._retired.discard(name)

    def drain_worker(self, name: str) -> List[int]:
        """Runtime shrink: stop feeding ``name`` (it finishes what it
        already admitted), moving its queued indices to the others."""
        with self._lock:
            moved = list(self._todo.get(name, ()))
            self._todo[name] = collections.deque()
            self._retired.add(name)
            survivors = self._survivors_locked()
            if moved and not survivors:
                raise RuntimeError(
                    f"cannot drain '{name}': no other workers")
            self._deal_locked(moved, survivors)
            return moved

    def rebalance(self):
        """Re-deal every *unstarted* index round-robin (ascending) over
        the current members (after a grow)."""
        with self._lock:
            names = self._survivors_locked()
            pending = sorted(n for q in self._todo.values() for n in q)
            for k in self._todo:
                self._todo[k] = collections.deque()
            self._deal_locked(pending, names)


_RETIRED = object()        # _drain_one: detached mid-wait, give up cleanly


# ---------------------------------------------------------------- the pool --

@dataclass
class PoolConfig:
    """Per-pool knobs.

    ``chunk_scheduling=False`` falls back to the monolithic
    ``gen.step()`` per batch (the complete-batch baseline).
    ``max_inflight`` bounds how many batches pipeline inside one worker's
    scheduler heap.  ``chunk_delay(batch_index, chunk_idx) -> seconds``
    injects straggler latency (tests and examples).  Executors that
    override ``step()`` without providing the chunk-stepping hooks should
    set ``chunk_scheduling=False``.
    """
    chunk_scheduling: bool = True
    early_exit: bool = True
    max_inflight: int = 2
    chunk_delay: Optional[Callable[[int, int], float]] = None
    # continuous-batching engine mode (repro_torch.rl.engine): row-granular
    # admission into an in-flight slot pool instead of batch-granular
    # chunk scheduling.  ``max_running_rows=0`` lets the engine size the
    # pool (2x one batch); ``engine_row_budgets`` injects per-row decode
    # budgets (stragglers); ``engine_round_delay_s`` sleeps per decode
    # round.
    engine: bool = False
    max_running_rows: int = 0
    engine_row_budgets: Optional[List[int]] = None
    engine_round_delay_s: float = 0.0
    # paged KV cache (models/paging.py): ``kv_layout="paged"`` replaces
    # the dense per-row ring with a shared page arena + per-row page
    # tables and radix prefix reuse ("" defers to $REPRO_KV_LAYOUT, then
    # dense).  kv_page_size=0 ->
    # 16; kv_pages=0 -> sized so every slot fits a full row.
    kv_layout: str = ""
    kv_page_size: int = 0
    kv_pages: int = 0

    def __post_init__(self):
        # the delay hook lives in RolloutScheduler.step: a monolithic
        # worker would silently ignore it
        if self.chunk_delay is not None and not self.chunk_scheduling:
            raise ValueError("chunk_delay requires chunk_scheduling=True")
        if self.engine and self.chunk_delay is not None:
            raise ValueError("engine mode takes no chunk_delay: it paces "
                             "rounds via engine_round_delay_s")


class GeneratorPool:
    """N generator worker loops fanning into one sample queue.

    Built by the async controller per ``run()``: the controller supplies
    the generator *handles*, each generator's live weight channels, the
    pool-outbound data channels (whose payloads travel by snapshot), the
    shared sample queue, the staleness-bounds policy and its ``_await``
    helper (deadline + stop-event slicing) and, when supervised, the
    ``Supervisor``.  ``loops(first, last, stop)`` hands back one callable
    per worker for the controller to wrap in guarded threads; each worker
    appends its busy intervals to ``intervals`` (thread-safe list
    appends) for the overlap stats.
    """

    def __init__(self, generators, channels_by_gen: Dict[str, list],
                 data_channels, sample_queue: StalenessBuffer, bounds, *,
                 config: Optional[PoolConfig] = None, timeout: float = 600.0,
                 await_fn=None, supervisor=None):
        if not generators:
            raise ValueError("a generator pool needs at least one generator")
        self.generators = list(generators)
        self.channels_by_gen = channels_by_gen
        self.data_channels = list(data_channels)
        self.sample_queue = sample_queue
        self.bounds = bounds
        self.config = config or PoolConfig()
        self.timeout = timeout
        self._await = await_fn
        self.supervisor = supervisor
        self.chaos = supervisor.chaos if supervisor is not None else None
        self.assignment: Optional[WorkAssignment] = None
        self._spawn_thread = None          # installed by the controller run
        self._stop: Optional[threading.Event] = None
        self.intervals: list = []          # (t0, t1) busy spans, all workers

    def loops(self, first: int, last: int, stop: threading.Event):
        """One (name, callable) per worker; worker ``i`` covers batches
        ``first+i, first+i+N, ...`` below ``last`` (the ``WorkAssignment``
        re-maps ownership on worker loss or runtime attach/detach)."""
        self.assignment = WorkAssignment(
            [g.name for g in self.generators], first, last)
        self._stop = stop
        return [(gen.name, (lambda gen=gen: self._worker(gen, stop)))
                for gen in self.generators]

    # ---------------------------------------------------------- elasticity --

    def attach(self, gen, channels):
        """Runtime grow: adopt a weight-replayed generator handle mid-run
        and start its worker thread.  The controller owns the surrounding
        wiring (channel creation, fabric add); see
        ``AsyncExecutorController.attach_generator``."""
        if self.assignment is None or self._spawn_thread is None:
            raise RuntimeError("attach requires a live run")
        self.generators.append(gen)
        self.channels_by_gen[gen.name] = list(channels)
        self.assignment.add_worker(gen.name)
        self.assignment.rebalance()
        self._on_resize()
        self._spawn_thread(
            gen.name, lambda gen=gen: self._worker(gen, self._stop))

    def detach(self, name_or_gen):
        """Runtime shrink: stop assigning new batches to this worker; it
        finishes its in-flight jobs, then its thread exits."""
        name = name_or_gen if isinstance(name_or_gen, str) \
            else name_or_gen.name
        if self.assignment is None:
            raise RuntimeError("detach requires a live run")
        moved = self.assignment.drain_worker(name)
        self._on_resize()
        return moved

    def _on_resize(self):
        n = len(self.assignment.survivors())
        if self.supervisor is not None:
            self.supervisor.on_pool_resize(n)   # logs, then tells bounds
            return
        cb = getattr(self.bounds, "on_pool_resize", None)
        if cb is not None:
            cb(n)

    # ------------------------------------------------------- weight drains --

    def _drain_one(self, gen, stop, what: str):
        """Blocking: receive one (version, params) pair from each of this
        worker's weight channels.  None means stopped by a peer;
        ``_RETIRED`` means the worker was detached mid-wait -- the fabric
        no longer publishes to its channels, so nothing will ever arrive
        and it must re-check its (now empty) assignment instead."""
        asn = self.assignment
        for ch in self.channels_by_gen[gen.name]:
            def recv_or_retire(t, c=ch):
                if asn.is_retired(gen.name):
                    return _RETIRED
                return c.recv(timeout=t)
            got = self._await(recv_or_retire, stop, what)
            if got is None or got is _RETIRED:
                return got
        return True

    def _poll_one(self, gen) -> bool:
        """Non-blocking: drain one pair per channel if already queued."""
        got = False
        for ch in self.channels_by_gen[gen.name]:
            try:
                ch.recv(timeout=0)
                got = True
            except queue.Empty:
                pass
        return got

    # -------------------------------------------------------- worker loops --

    def _push(self, gen, stop, item) -> Optional[bool]:
        version = item.pop("_version")
        return self._await(
            lambda t: self.sample_queue.push(version, item, timeout=t),
            stop, f"room in sample queue for batch {item['batch_index']}")

    @property
    def _snapshot_names(self):
        return [ch.name for ch in self.data_channels]

    def _fire_chaos(self, point, gen, index, chunk=None):
        if self.chaos is not None:
            self.chaos.fire(point, gen.name, index, chunk)

    def _recover(self, gen, sched, error) -> bool:
        """A generator RPC raised: hand the generator to the supervisor.

        True -> respawned (in-flight jobs re-pinned; retry the schedule).
        False -> lost; this worker's batches were failed over to the
        survivors and its thread should exit.  Re-raises when the pool
        is unsupervised, the supervisor declines (a timeout on a
        responsive actor), or nobody is left to degrade to."""
        sup = self.supervisor
        if sup is None or not sup.covers(gen):
            raise error
        outcome = sup.recover(gen, error)    # may re-raise `error`
        if outcome == RESPAWNED:
            for job in (sched.inflight() if sched is not None else ()):
                # the pinned params died with the process: take a fresh
                # pin under the replayed version, and check -- not
                # assume -- that the staleness bound still holds
                job2 = gen.call("repin_job", job)
                if job2 is not job:
                    job.__dict__.update(job2.__dict__)
                lag = job.batch_index - job.weight_version
                if not 0 <= lag <= job.bound:
                    raise RuntimeError(
                        f"re-admission of batch {job.batch_index} breaks "
                        f"the staleness bound: replayed version "
                        f"{job.weight_version}, bound {job.bound}")
            return True
        if outcome != LOST:
            raise RuntimeError(f"unknown recovery outcome {outcome!r}")
        if sched is not None:
            sched.clear()                    # states die; survivors redo
        self.assignment.fail_over(gen.name)  # raises when nobody is left
        self._on_resize()
        return False

    def _park(self, gen, stop) -> bool:
        """This worker's queue is empty but the pool is not done: wait
        briefly (a peer's loss or a rebalance may deal indices here).
        False -> exit."""
        if self.assignment.all_done() or self.assignment.idle(gen.name):
            return False
        stop.wait(0.05)
        return True

    def _worker(self, gen, stop: threading.Event):
        if self.config.engine and gen.engine_hooks:
            self._worker_engine(gen, stop)
        elif self.config.chunk_scheduling and gen.chunk_hooks:
            self._worker_chunked(gen, stop)
        else:
            self._worker_monolithic(gen, stop)

    def _worker_monolithic(self, gen, stop):
        """Complete-batch baseline: one blocking ``gen.step()`` per batch,
        pushed only when the whole batch finishes."""
        asn = self.assignment
        claimed = None           # started, not finished: requeued if the
        while not stop.is_set():  # generator dies and is respawned
            try:
                n = asn.next_for(gen.name)
                if n is None:
                    if not self._park(gen, stop):
                        return
                    continue
                idle = 0.0
                bound = self.bounds.bound()
                retired = False
                while gen.call("weight_version") < max(0, n - bound) and \
                        not stop.is_set():
                    t0 = time.monotonic()
                    with obs_trace.span("weight-wait", "genpool",
                                        worker=gen.name, batch=n):
                        got = self._drain_one(gen, stop,
                                              f"weights for batch {n}")
                    if got is None:
                        return
                    if got is _RETIRED:
                        retired = True
                        break
                    idle += time.monotonic() - t0
                    bound = self.bounds.bound()
                if stop.is_set():
                    return
                if retired or not asn.start(gen.name, n):
                    continue     # re-dealt away (or detached) mid-wait
                claimed = n
                self._fire_chaos("batch", gen, n)
                t0 = time.monotonic()
                with obs_trace.span("generate", "genpool",
                                    worker=gen.name, batch=n):
                    gen.call("set_step", n)
                    snapshot = gen.call("step_snapshot",
                                        self._snapshot_names)
                t1 = time.monotonic()
                self.intervals.append((t0, t1))
                item = {"batch_index": n, "snapshot": snapshot,
                        "generator": gen.name, "bound": bound,
                        "gen_busy_s": t1 - t0, "gen_idle_s": idle,
                        "_version": gen.call("weight_version")}
                if self._push(gen, stop, item) is None:
                    return
                asn.finish(gen.name, n)
                claimed = None
            except (ActorDied, TimeoutError) as e:
                if not self._recover(gen, None, e):
                    return
                if claimed is not None:
                    asn.requeue(gen.name, claimed)   # respawned: retry it
                    claimed = None

    def _worker_chunked(self, gen, stop):
        """Chunk-scheduled worker: admit batches the moment their pinned
        weight version lands, pipeline up to ``max_inflight`` of them
        through the scheduler heap, push each the moment it completes."""
        cfg = self.config
        asn = self.assignment
        sched = RolloutScheduler(
            _SnapshotEmitter(gen, self._snapshot_names, self.chaos),
            PartialRolloutCache(), early_exit=cfg.early_exit,
            chunk_delay=cfg.chunk_delay)
        pending_idle = 0.0                  # weight-wait time -> next admit
        claimed = None                      # started but not yet in sched
        while not stop.is_set():
            try:
                n = asn.next_for(gen.name)
                if n is None and sched.pending() == 0:
                    if not self._park(gen, stop):
                        return
                    continue
                if n is not None and sched.pending() < cfg.max_inflight:
                    bound = self.bounds.bound()
                    if gen.call("weight_version") >= max(0, n - bound):
                        if not asn.start(gen.name, n):
                            continue      # re-dealt away since the peek
                        claimed = n
                        self._fire_chaos("batch", gen, n)
                        t0 = time.monotonic()
                        with obs_trace.span("admit", "genpool",
                                            worker=gen.name, batch=n):
                            gen.call("set_step", n)
                            job, state = gen.begin_batch(n)
                            job.bound = bound
                            job.meta["idle_s"] = pending_idle
                            pending_idle = 0.0
                            sched.admit(job, state)
                        claimed = None    # now visible via sched.inflight
                        self.intervals.append((t0, time.monotonic()))
                        continue
                    if sched.pending() == 0:
                        # nothing in flight: block until the version lands
                        t0 = time.monotonic()
                        with obs_trace.span("weight-wait", "genpool",
                                            worker=gen.name, batch=n):
                            got = self._drain_one(gen, stop,
                                                  f"weights for batch {n}")
                        if got is None:
                            return
                        pending_idle += time.monotonic() - t0
                        continue
                    # in-flight work available: poll weights, don't block
                    self._poll_one(gen)
                if sched.pending() == 0:
                    continue
                t0 = time.monotonic()
                done = sched.step()
                self.intervals.append((t0, time.monotonic()))
                if done is None:
                    continue
                job, snapshot = done         # the emitter's port snapshot
                item = {"batch_index": job.batch_index,
                        "snapshot": snapshot,
                        "generator": gen.name, "bound": job.bound,
                        "gen_busy_s": job.busy_s,
                        "gen_idle_s": job.meta.get("idle_s", 0.0),
                        "_version": job.weight_version}
                if self._push(gen, stop, item) is None:
                    return
                asn.finish(gen.name, job.batch_index)
            except (ActorDied, TimeoutError) as e:
                if not self._recover(gen, sched, e):
                    return
                if claimed is not None:
                    asn.requeue(gen.name, claimed)   # died before admit
                    claimed = None

    # --------------------------------------------------------- engine mode --

    def _engine_configure(self, gen):
        cfg = self.config
        gen.call("engine_configure",
                 max_running_rows=cfg.max_running_rows,
                 row_budgets=cfg.engine_row_budgets,
                 round_delay_s=cfg.engine_round_delay_s,
                 kv_layout=cfg.kv_layout,
                 kv_page_size=cfg.kv_page_size,
                 kv_pages=cfg.kv_pages)

    def _worker_engine(self, gen, stop):
        """Continuous-batching worker: the engine lives inside the
        generator (the ``engine_*`` executor endpoints), so this loop
        only moves batch indices in and finished batches out.  Enqueue
        batches the moment their staleness gate opens, then drive
        ``engine_round`` -- each round admits waiting rows into freed
        slots, decodes every live row one chunk and harvests finished
        rows; batches emerge the moment their last group completes, in
        any order (the consumer reorders by index).

        Recovery: the engine -- slots, radix cache, parked rows -- dies
        with a killed process.  The supervisor's respawn replays the
        weights and then calls the re-admission hook registered here,
        which rebuilds the engine and re-enqueues every enqueued but
        unemitted batch as fresh rows under the replayed (newest
        staleness-legal) version; their decoded tokens are lost."""
        inflight: Dict[int, int] = {}     # batch index -> bound at enqueue
        self._engine_configure(gen)
        if self.supervisor is not None and self.supervisor.covers(gen):
            def readmit(gen=gen, inflight=inflight):
                self._engine_configure(gen)
                for b in sorted(inflight):
                    gen.call("engine_enqueue", b, inflight[b])
                if gen.call("engine_inflight") != sorted(inflight):
                    raise RuntimeError(
                        f"'{gen.name}': the rebuilt engine holds "
                        f"{gen.call('engine_inflight')}, not the "
                        f"re-enqueued batches {sorted(inflight)}")
                return sorted(inflight)
            self.supervisor.set_readmit(gen.name, readmit)
        try:
            self._engine_loop(gen, stop, inflight)
        except BaseException:
            # the loop's error is the one to report: drop the engine's
            # rows and pages on the way out without masking it
            with contextlib.suppress(Exception):
                gen.call("engine_abort")
            raise
        # drop parked pool state and radix pages (the paged engine
        # asserts that no page leaked); a lost generator has no engine
        if not self.assignment.is_retired(gen.name) or gen.healthy():
            gen.call("engine_abort")

    def _engine_loop(self, gen, stop, inflight: Dict[int, int]):
        cfg = self.config
        asn = self.assignment
        pending_idle = 0.0
        claimed = None
        while not stop.is_set():
            try:
                n = asn.next_for(gen.name)
                if n is None and not inflight:
                    if not self._park(gen, stop):
                        return
                    continue
                if n is not None and len(inflight) < cfg.max_inflight:
                    bound = self.bounds.bound()
                    if gen.call("weight_version") >= max(0, n - bound):
                        if not asn.start(gen.name, n):
                            continue      # re-dealt away since the peek
                        claimed = n
                        self._fire_chaos("batch", gen, n)
                        t0 = time.monotonic()
                        with obs_trace.span("enqueue", "genpool",
                                            worker=gen.name, batch=n):
                            gen.call("set_step", n)
                            gen.call("engine_enqueue", n, bound)
                        inflight[n] = bound
                        claimed = None
                        self.intervals.append((t0, time.monotonic()))
                        continue
                    if not inflight:
                        # nothing decoding: block until the version lands
                        t0 = time.monotonic()
                        with obs_trace.span("weight-wait", "genpool",
                                            worker=gen.name, batch=n):
                            got = self._drain_one(
                                gen, stop, f"weights for batch {n}")
                        if got is None:
                            return
                        pending_idle += time.monotonic() - t0
                        continue
                    # rows in flight: poll weights, don't block
                    self._poll_one(gen)
                if not inflight:
                    continue
                t0 = time.monotonic()
                with obs_trace.span("engine-round", "genpool",
                                    worker=gen.name,
                                    inflight=len(inflight)):
                    items = gen.call("engine_round", self._snapshot_names)
                self.intervals.append((t0, time.monotonic()))
                for item in items:
                    item["gen_idle_s"] = pending_idle
                    pending_idle = 0.0
                    b = item["batch_index"]
                    if self._push(gen, stop, item) is None:
                        return
                    asn.finish(gen.name, b)
                    inflight.pop(b, None)
            except (ActorDied, TimeoutError) as e:
                if not self._recover(gen, None, e):
                    inflight.clear()          # failed over to survivors
                    return
                # respawned: the supervisor's readmit hook already
                # rebuilt the engine and re-enqueued `inflight`
                if claimed is not None:
                    asn.requeue(gen.name, claimed)  # died before enqueue
                    claimed = None
