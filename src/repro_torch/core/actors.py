"""Placement-agnostic actor API (the port of the JAX package's
``core/actors.py``): one single-controller contract for thread-,
process-, shared-memory- and socket-backed executors (paper Sec. 5.1,
5.2).

The controller, the channels and the generator pool hold
``ActorHandle``s, never raw executors: ``call`` is a synchronous endpoint
(a method, or a plain attribute read), ``cast`` a fire-and-forget send,
plus ``healthy`` / ``join`` / ``close``.  Under every handle sits a
transport:

  * ``InprocTransport`` -- the executor lives in this process; endpoints
    are direct calls on the caller's thread.  ``prepare`` stages a
    weight payload onto the executor's device (DDMA or the
    parameter-server path).
  * ``ProcTransport`` -- the executor is built inside a *spawned* child
    with its own interpreter lock, CUDA context and default stream;
    endpoints travel a Unix socket pair as ``repro_torch.core.wire``
    payloads.  Remote exceptions re-raise on the caller with the remote
    traceback as ``__cause__``; a dead child surfaces as ``ActorDied``
    instead of a hang; ``close()`` shuts the server down and joins the
    child.
  * ``ShmTransport`` -- ``ProcTransport`` whose data plane is shared
    memory: payloads above a size threshold are written straight into
    ``multiprocessing.shared_memory`` ring slots (``wire.serialize_into``
    copies each leaf once, into its final position: a CUDA leaf by one
    device-to-host copy) and only a small header crosses the socket.
    Slots are recycled on the receiver's ack, sent only after the payload
    was copied out; every segment is created, and on ``close()``
    unlinked, by the parent, so a killed child leaks nothing in
    ``/dev/shm``.
  * ``SocketTransport`` -- the same wire format and server loop over TCP,
    for executors on independently launched hosts (``python -m
    repro_torch.launch.train --listen HOST:PORT``).  With no address it
    self-hosts: a spawned helper binds an ephemeral localhost port and
    serves one actor.

A remote transport's ``prepare`` is the identity: the serialization at
the boundary is the staging.  Where a tensor lands is the wire's rule: a
CUDA tensor arrives on the receiver's CUDA device, a CPU tensor on its
CPU.

``DeviceSpec`` gives a spawned child its own cards: ``device_count`` sets
``CUDA_VISIBLE_DEVICES`` in the child before torch touches CUDA, and an
executor that takes ``device`` is handed the child's first card.  Its
``mesh_shape`` gives the executor a ``DeviceMesh`` of the child's own
(``mesh=``): a torch mesh of n ranks is n processes, so a child whose
mesh has more than one rank is the mesh's rank 0, spawns the other ranks
and runs every endpoint call on all of them (``_MeshWorld``).

Ordering: operations through one handle execute in the order they were
sent (direct calls trivially; the socket is FIFO and the server
single-threaded), so ``cast("set_weights", ...)`` then
``call("weight_version")`` observes the cast.

``spawn_actor(factory, *args, transport=..., **kwargs)`` builds an
executor behind a handle; ``transport=None`` reads ``REPRO_TRANSPORT``
(default ``inproc``).  The factory and its arguments must pickle for the
remote transports.  ``ActorHandle.respawn`` rebuilds a dead actor from
that recorded spec in place (``repro_torch.core.supervise`` drives it).
"""
from __future__ import annotations

import collections
import inspect
import logging
import multiprocessing as mp
import os
import pickle
import select
import shutil
import socket as socketlib
import struct
import tempfile
import threading
import time
import traceback
import weakref
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import ddma, wire
from repro_torch.obs import trace as obs_trace

_log = logging.getLogger(__name__)

TRANSPORTS = ("inproc", "proc", "shm", "socket")

#: max events per piggybacked ``("__trace__", events)`` frame, so a
#: long-buffering child never turns one reply into a giant frame
_TRACE_FLUSH_BATCH = 512


class ActorDied(RuntimeError):
    """The process or host backing an actor exited (or was killed, or
    its connection dropped): the handle fails fast instead of blocking
    on a channel nobody will write."""


class RemoteActorError(RuntimeError):
    """Carries a remote traceback.  When the remote exception pickles it
    re-raises as its own type with this as its ``__cause__``; otherwise
    this is the raised error."""


def _pack_exc(e: BaseException) -> Tuple[Optional[bytes], str]:
    tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
    try:
        blob = pickle.dumps(e)
    except Exception:
        blob = None
    return blob, tb


def _unpack_exc(payload, actor: str) -> BaseException:
    blob, tb = payload
    cause = RemoteActorError(f"remote traceback from actor '{actor}':\n{tb}")
    if blob is not None:
        try:
            exc = pickle.loads(blob)
        except Exception:
            exc = None
        if isinstance(exc, BaseException):
            exc.__cause__ = cause
            return exc
    return cause


# ------------------------------------------------------------ device specs --

@dataclass(frozen=True)
class DeviceSpec:
    """A spawned child's device world.

    ``device_count`` > 0 gives the child the first ``device_count`` cards
    this process sees (``CUDA_VISIBLE_DEVICES``, set in the child before
    torch initializes CUDA; a ``--listen`` host sets its own at launch),
    and hands an executor that takes ``device`` the child's first card.

    ``mesh_shape`` / ``mesh_axes`` give the executor a ``DeviceMesh`` of
    that shape as its ``mesh=`` kwarg, built from the child's own world
    (``build_mesh``).  A mesh of more than one rank makes the child its
    rank 0: it spawns the other ranks, one card each in its
    ``CUDA_VISIBLE_DEVICES`` order (gloo ranks on the CPU when the
    executor is asked for ``device="cpu"``), joins them on a ``file://``
    rendezvous in a directory of its own and runs each endpoint call on
    every rank; only rank 0 replies.  A mesh of one rank is a world of one
    and spawns nothing."""
    device_count: int = 0
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if self.mesh_shape and (len(self.mesh_shape) != len(self.mesh_axes)
                                or min(self.mesh_shape) < 1):
            raise ValueError(f"mesh_shape {self.mesh_shape} over axes "
                             f"{self.mesh_axes}")

    @property
    def mesh_size(self) -> int:
        """The mesh's ranks (0 without a mesh)."""
        if not self.mesh_shape:
            return 0
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n

    def apply_env(self):
        if self.device_count > 0:
            seen = os.environ.get("CUDA_VISIBLE_DEVICES")
            cards = [c for c in seen.split(",") if c.strip()] \
                if seen is not None else \
                [str(i) for i in range(self.device_count)]
            os.environ["CUDA_VISIBLE_DEVICES"] = \
                ",".join(cards[:self.device_count])

    def executor_kwargs(self, factory, kwargs: Dict[str, Any]):
        """``kwargs`` with ``device`` pointed at the child's first card,
        for a factory that takes one (a CPU device stays)."""
        if self.device_count <= 0 or not _takes(factory, "device"):
            return kwargs
        dev = kwargs.get("device")
        if dev is not None and str(dev).split(":")[0] != "cuda":
            return kwargs
        return dict(kwargs, device="cuda")

    def build_mesh(self, device_type: str = "cuda"):
        """This process's world as a ``DeviceMesh`` of ``mesh_shape`` (None
        without one).  The world must hold exactly the mesh's ranks
        (``launch/mesh.join``); a mesh of one rank joins a world of one
        where there is none yet."""
        if not self.mesh_shape:
            return None
        import torch.distributed as dist
        from repro_torch.launch import mesh as meshmod
        if not dist.is_initialized():
            if self.mesh_size != 1:
                raise ValueError(
                    f"a mesh {self.mesh_shape} of {self.mesh_size} ranks is "
                    f"that many processes: join them first (launch/mesh."
                    f"join), or give the spec to a spawned child")
            meshmod.join_world_of_one(device_type)
        return meshmod.make_mesh(self.mesh_shape, self.mesh_axes,
                                 device_type=device_type)


def _mesh_device_type(kwargs) -> str:
    """The device type of an executor's mesh: its ``device``'s (cuda when
    none is given, as the executors default)."""
    import torch
    return torch.device(kwargs.get("device") or "cuda").type


def _takes(factory, name: str) -> bool:
    try:
        return name in inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return False


# ------------------------------------------------------ a child's own mesh --

def _mesh_send(msg, device_type: str):
    """Rank 0: broadcast one endpoint message (None: the end) to the
    mesh's other ranks as wire bytes."""
    import torch
    import torch.distributed as dist
    dev = ddma.rank_device(device_type)
    data = bytearray() if msg is None else wire.serialize(msg)
    dist.broadcast(torch.tensor([len(data)], dtype=torch.int64, device=dev),
                   src=0)
    if data:
        dist.broadcast(torch.frombuffer(data, dtype=torch.uint8).to(dev),
                       src=0)


def _mesh_recv(device_type: str):
    """Another rank: the next endpoint message of rank 0 (None: the
    end)."""
    import torch
    import torch.distributed as dist
    dev = ddma.rank_device(device_type)
    n = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(n, src=0)
    if int(n) == 0:
        return None
    buf = torch.empty(int(n), dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=0)
    return wire.deserialize(memoryview(buf.cpu().numpy()))


def _exit_with(ppid: int):
    """A mesh rank's watchdog: leave when rank 0, its parent, is gone."""
    while os.getppid() == ppid:
        time.sleep(1.0)
    os._exit(1)


def _mesh_rank_main(factory, args, kwargs, spec, rank, init_method,
                    device_type, card, ppid):
    """A rank of a child's own mesh other than 0: join the world, build
    the mesh and the executor, then run every endpoint message rank 0
    broadcasts until the end message."""
    if card is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = card
    threading.Thread(target=_exit_with, args=(ppid,), daemon=True,
                     name="mesh-rank-watchdog").start()
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshmod
    meshmod.join(init_method, rank, spec.mesh_size, device_type=device_type)
    try:
        ex = factory(*args, **dict(kwargs,
                                   mesh=spec.build_mesh(device_type)))
        while True:
            msg = _mesh_recv(device_type)
            if msg is None:
                return
            method, cargs, ckw = msg
            try:
                _invoke(ex, method, cargs, ckw)
            except Exception:
                # rank 0 runs the same call and answers for the mesh
                _log.exception("mesh rank %d: endpoint '%s'", rank, method)
    finally:
        dist.destroy_process_group()


class _MeshWorld:
    """The world of a spawned child's own mesh, this process its rank 0:
    the other ranks (spawned here), the process group and the
    ``DeviceMesh``.  ``broadcast`` hands each endpoint message to the
    other ranks before rank 0 runs it; ``close`` ends them, reaps them
    and leaves the group."""

    def __init__(self, spec: DeviceSpec, factory, args, kwargs,
                 device_type: str):
        from repro_torch.launch import mesh as meshmod
        self.device_type = device_type
        self._dir = tempfile.mkdtemp(prefix="repro-mesh-")
        self._procs: List[Any] = []
        self._joined = False
        n = spec.mesh_size
        init = "file://" + os.path.join(self._dir, "rendezvous")
        try:
            if n > 1:
                cards = self._cards(n) if device_type == "cuda" \
                    else [None] * n
                # a spawned actor is a daemon, and multiprocessing lets a
                # daemon start no process: its ranks are its own, reaped
                # by close() and, should it die, by their watchdogs
                mp.current_process()._config["daemon"] = False
                ctx = mp.get_context("spawn")
                for r in range(1, n):
                    p = ctx.Process(
                        target=_mesh_rank_main,
                        args=(factory, tuple(args), dict(kwargs), spec, r,
                              init, device_type, cards[r], os.getpid()),
                        daemon=True, name=f"mesh-rank{r}")
                    p.start()
                    self._procs.append(p)
            meshmod.join(init, 0, n, device_type=device_type)
            self._joined = True
            self.mesh = spec.build_mesh(device_type)
        except BaseException:
            self.close()
            raise

    @staticmethod
    def _cards(n: int) -> List[str]:
        import torch
        seen = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = [c.strip() for c in seen.split(",") if c.strip()] \
            if seen is not None else \
            [str(i) for i in range(torch.cuda.device_count())]
        if len(cards) < n:
            raise ValueError(f"a mesh of {n} ranks needs {n} cards; the "
                             f"child sees {len(cards)}")
        return cards[:n]

    def broadcast(self, msg):
        if not self._procs:
            return
        dead = [p.name for p in self._procs if not p.is_alive()]
        if dead:
            raise ActorDied(f"mesh ranks {dead} exited")
        _mesh_send(msg, self.device_type)

    def close(self):
        import torch.distributed as dist
        if self._joined:
            self._joined = False
            if self._procs and all(p.is_alive() for p in self._procs):
                try:
                    _mesh_send(None, self.device_type)
                except Exception as e:       # pragma: no cover - best effort
                    _log.debug("mesh end message not sent: %r", e)
            dist.destroy_process_group()
        for p in self._procs:
            _reap(p)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)


# --------------------------------------------------------------- transports --

def _describe_executor(ex, fallback_name: str) -> Dict[str, Any]:
    """The actor's identity and capability flags, read off the executor
    where it lives, so in-process and remote handles never disagree."""
    return {"name": getattr(ex, "name", fallback_name),
            "role": getattr(ex, "role", "generic"),
            "chunk_hooks": hasattr(ex, "begin_batch"),
            "pinned_hooks": hasattr(ex, "begin_batch_pinned"),
            "engine_hooks": hasattr(ex, "engine_round"),
            "staged_weights": hasattr(ex, "stage_weights")
            and hasattr(ex, "set_weights")}


def _invoke(ex, method: str, args, kwargs):
    """A callable attribute is invoked, a plain attribute is read."""
    attr = getattr(ex, method)
    if callable(attr):
        return attr(*args, **(kwargs or {}))
    if args or kwargs:
        raise TypeError(f"'{method}' is an attribute, not an endpoint")
    return attr


class Transport:
    """Hosts one actor and carries its endpoints."""

    #: True when endpoints cross a process boundary (payloads serialized)
    remote: bool = False

    def describe(self) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def device(self):
        """The executor's device where the fabric should stage toward it;
        None for remote actors, whose staging is the serialization."""
        return None

    def call(self, method: str, args=(), kwargs=None,
             timeout: Optional[float] = None):
        raise NotImplementedError

    def cast(self, method: str, args=(), kwargs=None):
        raise NotImplementedError

    def prepare(self, data, comm_type):
        return data

    def drain_trace(self) -> int:
        """Pull buffered remote trace events (0 in process, where events
        land in this process's tracer directly)."""
        return 0

    def healthy(self) -> bool:
        return True

    def join(self, timeout: Optional[float] = None):
        pass

    def close(self):
        pass


class InprocTransport(Transport):
    """The executor lives in this process; endpoints are direct calls."""

    def __init__(self, executor):
        self.executor = executor

    def describe(self) -> Dict[str, Any]:
        return _describe_executor(self.executor,
                                  type(self.executor).__name__)

    @property
    def device(self):
        return getattr(self.executor, "device", None)

    def call(self, method, args=(), kwargs=None, timeout=None):
        return _invoke(self.executor, method, args, kwargs)

    def cast(self, method, args=(), kwargs=None):
        self.call(method, args, kwargs)

    @property
    def mesh(self):
        return getattr(self.executor, "mesh", None)

    def prepare(self, data, comm_type):
        """Stage a channel payload toward this actor: for weight payloads
        the DDMA (or the parameter-server) transfer, replicated over the
        executor's mesh or onto its device; on a mesh, every other tensor
        placed by ``_payload_placements``; the identity otherwise."""
        from repro_torch.core.channels import CommType   # import cycle
        mesh = self.mesh
        if comm_type.is_weights:
            target = mesh if mesh is not None else self.device
            if target is None:
                return data
            sync = (ddma.ddma_weight_sync
                    if comm_type == CommType.DDMA_WEIGHTS_UPDATE
                    else ddma.ps_weight_sync)
            return sync(data, target)
        if mesh is None:
            return data
        return _place_payload(data, mesh, comm_type)


def _payload_placements(mesh, comm_type, x) -> list:
    """The DTensor placements of a payload tensor on ``mesh`` (the
    reference's ``_payload_sharding``): a ``SCATTER`` payload of at least
    one dim split on dim 0 over the first mesh axis, anything else
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core.channels import CommType   # import cycle
    out = [Replicate()] * mesh.ndim
    if comm_type == CommType.SCATTER and x.dim() >= 1:
        out[0] = Shard(0)
    return out


def _place_payload(data, mesh, comm_type):
    import torch
    from torch.distributed.tensor import distribute_tensor
    dev = ddma.rank_device(mesh.device_type)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if type(x) in (list, tuple):
            return type(x)(place(v) for v in x)
        if isinstance(x, torch.Tensor):
            # every rank holds the same payload: each keeps its own block
            return distribute_tensor(x.to(dev), mesh,
                                     _payload_placements(mesh, comm_type, x),
                                     src_data_rank=None)
        return x
    return place(data)


# ------------------------------------------------------------- connections --

_FRAME = struct.Struct(">Q")


class _SockConn:
    """Length-prefixed frames over a stream socket: the Unix socket pair
    of a spawned child, or a TCP connection.  ``recv_bytes`` reads each
    frame straight into one writable buffer, so a gigabyte weight frame is
    copied once on receipt (``multiprocessing``'s pipe builds a
    ``BytesIO`` and returns read-only bytes)."""

    def __init__(self, sock: socketlib.socket):
        if sock.family in (socketlib.AF_INET, socketlib.AF_INET6):
            sock.setsockopt(socketlib.IPPROTO_TCP, socketlib.TCP_NODELAY, 1)
        sock.settimeout(None)
        self._sock = sock

    def send_bytes(self, data):
        try:
            self._sock.sendall(_FRAME.pack(len(data)))
            self._sock.sendall(data)
        except OSError as e:
            raise BrokenPipeError(str(e)) from e

    def _recv_exact(self, n: int) -> memoryview:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self._sock.recv_into(view[got:], n - got)
            if k == 0:
                raise EOFError("connection closed by peer")
            got += k
        return view

    def recv_bytes(self) -> memoryview:
        (n,) = _FRAME.unpack(self._recv_exact(_FRAME.size))
        return self._recv_exact(n)

    def poll(self, timeout: float = 0.0) -> bool:
        r, _, _ = select.select([self._sock], [], [], max(0.0, timeout))
        return bool(r)

    def close(self):
        try:
            self._sock.shutdown(socketlib.SHUT_RDWR)
        except OSError as e:
            # ENOTCONN when the peer closed first: normal
            _log.debug("socket shutdown during close: %r", e)
        self._sock.close()


# ----------------------------------------------------- shared-memory plane --
#
# Frames on the connection are tagged:
#
#   0x00 + wire bytes                      inline message (small payloads)
#   0x01 + pickle((slot, seg_name, n))     message lives in a shm slot
#   0x02 + pickle([slot, ...])             receiver acks consumed slots
#
# Each direction has its own ring.  The parent creates every segment of
# both rings (the child only attaches), so ``close()`` can unlink them all
# even after a killed child.  A slot is released only when the receiver
# acks it after copying the payload out (``wire.deserialize`` keeps no
# views), so a slot being rewritten is never one being read.

_SHM_REGISTRY: Dict[str, shared_memory.SharedMemory] = {}
_SHM_REGISTRY_LOCK = threading.Lock()

SHM_THRESHOLD_DEFAULT = 1 << 16          # 64 KiB
SHM_SLOTS_DEFAULT = 4
SHM_SLOT_BYTES_DEFAULT = 32 << 20        # fixed child->parent slot size


class _RingFull(Exception):
    """No free slot right now: the sender must pump acks and retry."""


def _shm_create(size: int) -> shared_memory.SharedMemory:
    seg = shared_memory.SharedMemory(create=True, size=size)
    with _SHM_REGISTRY_LOCK:
        _SHM_REGISTRY[seg.name] = seg
    return seg


def _shm_unlink(seg: shared_memory.SharedMemory):
    with _SHM_REGISTRY_LOCK:
        _SHM_REGISTRY.pop(seg.name, None)
    try:
        seg.close()
    except BufferError:     # pragma: no cover - a view outlived the codec
        pass
    try:
        seg.unlink()
    except FileNotFoundError:    # pragma: no cover - already gone
        pass


def _shm_attach(name: str) -> shared_memory.SharedMemory:
    """Attach to a parent-created segment without registering it with the
    (shared) resource tracker: attaching registers it a second time, and
    an unregister then strips the *parent's* registration (the 3.13
    ``track=False`` semantics)."""
    from multiprocessing import resource_tracker
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class _ShmRing:
    """Sender-side slot allocator over a ring of shm segments.

    ``grow=True`` (parent -> child): slots are created or replaced on
    demand to fit the payload, always by the parent.  ``grow=False``
    (child -> parent): the parent created fixed-size segments at spawn
    and the child only attaches; a payload that can never fit goes
    inline."""

    def __init__(self, n_slots: int, *, grow: bool, min_bytes: int,
                 segments: Optional[List[shared_memory.SharedMemory]] = None):
        self._grow = grow
        self._min_bytes = max(1, min_bytes)
        self._lock = threading.Lock()
        self._slots: List[Optional[shared_memory.SharedMemory]] = \
            list(segments) if segments is not None else [None] * n_slots
        self._views = [memoryview(s.buf) if s is not None else None
                       for s in self._slots]
        self._free = [True] * len(self._slots)
        self.created: List[shared_memory.SharedMemory] = []

    def try_acquire(self, nbytes: int):
        """(slot index, writable view, segment name), or None (full)."""
        with self._lock:
            for i, seg in enumerate(self._slots):
                if seg is not None and self._free[i] and seg.size >= nbytes:
                    self._free[i] = False
                    return i, self._views[i], seg.name
            if not self._grow:
                return None
            for i, seg in enumerate(self._slots):
                if self._free[i]:
                    if seg is not None:
                        self._views[i].release()
                        _shm_unlink(seg)
                    seg = _shm_create(max(nbytes, self._min_bytes))
                    self.created.append(seg)
                    self._slots[i] = seg
                    self._views[i] = memoryview(seg.buf)
                    self._free[i] = False
                    return i, self._views[i], seg.name
            return None

    def can_fit(self, nbytes: int) -> bool:
        if self._grow:
            return True
        with self._lock:
            return any(s is not None and s.size >= nbytes
                       for s in self._slots)

    def release(self, idx: int):
        with self._lock:
            self._free[idx] = True

    def close(self):
        with self._lock:
            for v in self._views:
                if v is not None:
                    v.release()
            self._views = [None] * len(self._slots)


def _inline_frame(planned: wire.Planned, tag: Optional[int]) -> bytearray:
    """The serialized payload in one buffer, behind an optional tag byte:
    the leaves are written into the frame itself, with no second copy."""
    head = 0 if tag is None else 1
    frame = bytearray(head + planned.size)
    if tag is not None:
        frame[0] = tag
    wire.serialize_into(planned, memoryview(frame)[head:])
    return frame


class _PlainCodec:
    """Frames are raw wire bytes; nothing rides shared memory.

    Encoding is split in two so a ring-full retry never redoes the
    expensive part: ``prepare`` plans (and here serializes) once,
    ``encode_prepared`` turns the result into the frame."""

    def prepare(self, obj):
        return _inline_frame(wire.plan(obj), None)

    def encode_prepared(self, prep):
        return prep

    def decode(self, frame):
        return "msg", wire.deserialize(frame), None

    def close(self):
        pass


class _ShmCodec:
    """Tagged frames; payloads of at least ``threshold`` bytes ride ``tx``
    ring slots.

    ``rx_fixed`` maps the segment names this side may receive in to
    segments it already opened (the parent's view of the child's ring);
    any other segment is attached on first reference (the child's view of
    the parent's growable ring) and attached again when its slot's
    segment was replaced by a larger one."""

    def __init__(self, tx: Optional[_ShmRing], threshold: int, *,
                 rx_fixed: Optional[Dict[str, shared_memory.SharedMemory]]
                 = None, attach_rx: bool = False):
        self.tx = tx
        self.threshold = max(1, threshold)
        self._attach_rx = attach_rx
        self._rx: Dict[int, tuple] = {}       # slot idx -> (name, seg, view)
        self._rx_fixed = dict(rx_fixed or {})
        self._rx_fixed_views: Dict[str, memoryview] = {}

    def prepare(self, obj):
        """One planning pass: a payload that goes inline is serialized
        here; a ring-bound one stays ``Planned``, so a ``_RingFull`` retry
        repeats only the slot acquisition."""
        planned = wire.plan(obj)
        if self.tx is None or planned.size < self.threshold or \
                not self.tx.can_fit(planned.size):
            return _inline_frame(planned, 0)
        return planned

    def encode_prepared(self, prep):
        if not isinstance(prep, wire.Planned):
            return prep
        got = self.tx.try_acquire(prep.size)
        if got is None:
            raise _RingFull
        idx, view, name = got
        wire.serialize_into(prep, view)
        return b"\x01" + pickle.dumps((idx, name, prep.size))

    def decode(self, frame):
        """(kind, payload, ack frame to send or None)."""
        tag = frame[0]
        body = memoryview(frame)[1:]
        if tag == 0:
            return "msg", wire.deserialize(body), None
        if tag == 2:
            for idx in pickle.loads(body):
                self.tx.release(idx)
            return "ack", None, None
        if tag != 1:
            raise ValueError(f"bad frame tag {tag}")
        idx, name, nbytes = pickle.loads(body)
        view = self._rx_view(idx, name)
        obj = wire.deserialize(view[:nbytes])
        # the payload is copied out: hand back the ack that frees the slot
        return "msg", obj, b"\x02" + pickle.dumps([idx])

    def _rx_view(self, idx: int, name: str) -> memoryview:
        if name in self._rx_fixed:
            view = self._rx_fixed_views.get(name)
            if view is None:
                view = self._rx_fixed_views[name] = \
                    memoryview(self._rx_fixed[name].buf)
            return view
        cur = self._rx.get(idx)
        if cur is None or cur[0] != name:     # slot segment was replaced
            if cur is not None:
                cur[2].release()
                cur[1].close()
            if not self._attach_rx:
                raise ValueError(f"unknown shm segment {name!r}")
            seg = _shm_attach(name)
            cur = (name, seg, memoryview(seg.buf))
            self._rx[idx] = cur
        return cur[2]

    def close(self):
        for _, seg, view in self._rx.values():
            view.release()
            try:
                seg.close()
            except BufferError:  # pragma: no cover - a failed decode's
                pass             # traceback still holds a view
        self._rx.clear()
        for view in self._rx_fixed_views.values():
            view.release()
        self._rx_fixed_views.clear()
        if self.tx is not None:
            self.tx.close()


def _make_child_codec(boot: Dict[str, Any]):
    shm_boot = boot.get("shm")
    if not shm_boot:
        return _PlainCodec()
    segs = [_shm_attach(n) for n in shm_boot["child_tx_names"]]
    ring = _ShmRing(len(segs), grow=False, min_bytes=1, segments=segs)
    return _ShmCodec(ring, shm_boot["threshold"], attach_rx=True)


# -------------------------------------------------------------- the server --
# Child-side server: one message loop, one executor, FIFO execution.  It
# runs in a spawned interpreter (or a --listen host), with its own
# interpreter lock and CUDA context.

def _actor_server(conn, factory, args, kwargs, boot=None):
    boot = boot or {}
    spec: Optional[DeviceSpec] = boot.get("device_spec")
    if spec is not None and boot.get("apply_device_env"):
        # fresh interpreter: torch has not initialized CUDA yet, so the
        # card list still takes effect
        spec.apply_env()
    if boot.get("trace"):
        # programmatic enable (no REPRO_TRACE in this interpreter's
        # environment, e.g. a --listen host): trace as the parent does
        obs_trace.enable()
    codec = _make_child_codec(boot)
    pending: collections.deque = collections.deque()

    def pump_once(block: bool) -> bool:
        """Read one frame; acks release tx slots, messages queue."""
        if not block and not conn.poll(0):
            return False
        frame = conn.recv_bytes()
        with obs_trace.span("deserialize", "wire", bytes=len(frame)):
            kind, obj, ack = codec.decode(frame)
        if ack is not None:
            conn.send_bytes(ack)
        if kind == "msg":
            pending.append(obj)
        return True

    def send_obj(obj):
        prep = codec.prepare(obj)
        while True:
            try:
                frame = codec.encode_prepared(prep)
                break
            except _RingFull:
                # the parent is draining our replies: an ack frees a slot
                pump_once(block=True)
        conn.send_bytes(frame)

    def next_msg():
        while not pending:
            pump_once(block=True)
        return pending.popleft()

    def flush_trace():
        """Ship buffered events to the parent as ``__trace__`` frames,
        just before a reply, so the parent absorbs them while it drains
        for that reply."""
        t = obs_trace.tracer()
        if t is None:
            return
        evs = t.drain()
        while evs:
            send_obj(("__trace__", evs[:_TRACE_FLUSH_BATCH]))
            evs = evs[_TRACE_FLUSH_BATCH:]

    world: Optional[_MeshWorld] = None
    try:
        try:
            kwargs = dict(kwargs or {})
            if spec is not None:
                kwargs = spec.executor_kwargs(factory, kwargs)
                if spec.mesh_shape and "mesh" not in kwargs:
                    world = _MeshWorld(spec, factory, args, kwargs,
                                       _mesh_device_type(kwargs))
                    kwargs["mesh"] = world.mesh
            ex = factory(*args, **kwargs)
            desc = _describe_executor(ex, getattr(factory, "__name__", "?"))
            if obs_trace.enabled():
                # the process label is the actor name: one pid row per
                # actor in the exported timeline
                obs_trace.enable(desc["name"])
            send_obj(("hello", desc))
        except Exception as e:
            send_obj(("hello_err", _pack_exc(e)))
            return
        while True:
            try:
                msg = next_msg()
            except (EOFError, OSError):
                return                       # parent went away
            # tracing parents append a flow id; untraced ones send 5
            seq, kind, method, cargs, ckw, *rest = msg
            if kind == "trace_sync":
                # clock-offset handshake: answer at once (its round trip
                # bounds the offset error)
                send_obj((seq, "ok", obs_trace.now()))
                continue
            if kind == "drain_trace":
                t = obs_trace.tracer()
                send_obj((seq, "ok", t.drain() if t is not None else []))
                continue
            if kind == "shutdown":
                if world is not None:
                    world.close()
                flush_trace()                # the last drain rides the ack
                send_obj((seq, "ok", None))
                return
            try:
                if world is not None:
                    # the mesh's other ranks run the same call (SPMD)
                    world.broadcast((method, cargs, ckw))
                t = obs_trace.tracer()
                if t is None:
                    result = _invoke(ex, method, cargs, ckw)
                else:
                    with t.span(f"serve:{method}", "rpc"):
                        if rest and rest[0]:
                            t.flow_end(rest[0])
                        result = _invoke(ex, method, cargs, ckw)
                if kind == "call":
                    flush_trace()
                    send_obj((seq, "ok", result))
            except Exception as e:
                # call errors answer the caller; cast errors surface on
                # the next call through this handle (FIFO)
                flush_trace()
                send_obj((seq, "err", _pack_exc(e)))
    except (EOFError, OSError):
        return                               # peer vanished mid-reply
    finally:
        if world is not None:
            world.close()
        codec.close()


def _proc_actor_main(sock, factory, args, kwargs, boot):
    """A spawned child's entry point: serve one actor over its end of the
    socket pair."""
    conn = _SockConn(sock)
    try:
        _actor_server(conn, factory, args, kwargs, boot)
    finally:
        conn.close()


_LIVE_TRANSPORTS: "weakref.WeakSet[_RpcTransport]" = weakref.WeakSet()


class _RpcTransport(Transport):
    """RPC over a framed connection and a codec.

    A per-handle lock serializes request/reply pairs, so replies match
    requests without a reader thread; peer liveness is polled while
    waiting, so a dead peer raises ``ActorDied`` within about 0.1 s
    instead of at the deadline.  Subclasses supply the connection, the
    codec, liveness and teardown."""

    _POLL_S = 0.1
    remote = True

    def _init_rpc(self, conn, codec, call_timeout: float):
        self._conn = conn
        self._codec = codec
        self._lock = threading.RLock()
        self._seq = 0
        self._abandoned: set = set()     # seqs whose caller timed out
        self._stash: collections.deque = collections.deque()
        self._closed = False
        self.call_timeout = call_timeout
        self.on_death = None             # liveness hook: cb(ActorDied)
        self._death_notified = False
        self._trace_offset = 0.0         # child clock -> our trace epoch
        _LIVE_TRANSPORTS.add(self)

    def _handshake(self, spawn_timeout: float, factory):
        try:
            status, payload = self._recv(spawn_timeout,
                                         what="actor handshake")
        except BaseException:
            self._teardown()
            raise
        if status == "hello_err":
            self._teardown()
            raise _unpack_exc(payload, getattr(factory, "__name__", "?"))
        if status != "hello":
            self._teardown()
            raise RuntimeError(f"bad actor handshake {status!r}")
        self._desc = payload
        self._clock_sync()

    # ------------------------------------------------------------ plumbing --

    def describe(self):
        return dict(self._desc)

    @property
    def name(self):
        return getattr(self, "_desc", {}).get("name", "?")

    def _peer_alive(self) -> bool:
        raise NotImplementedError

    def _exit_desc(self) -> str:
        raise NotImplementedError

    def _died(self, what) -> ActorDied:
        """Mark the peer gone and build the error; the ``on_death`` hook
        fires once, on the first poll or receive that finds it gone."""
        self._closed = True
        err = ActorDied(
            f"actor '{self.name}' {self._exit_desc()} during {what}")
        cb, self.on_death = self.on_death, None
        if cb is not None and not self._death_notified:
            self._death_notified = True
            try:
                cb(err)
            except Exception:                # pragma: no cover - diagnostics
                _log.exception("on_death callback for '%s'", self.name)
        return err

    def _decode_frame(self, frame, what):
        """One decoded frame: acks are internal, messages come back."""
        t = obs_trace.tracer()
        if t is None:
            kind, obj, ack = self._codec.decode(frame)
        else:
            with t.span("deserialize", "wire", actor=self.name,
                        bytes=len(frame)):
                kind, obj, ack = self._codec.decode(frame)
        if ack is not None:
            try:
                self._conn.send_bytes(ack)
            except (BrokenPipeError, OSError):
                raise self._died(what)
        return kind, obj

    def _absorb_if_trace(self, obj) -> bool:
        """Absorb a piggybacked ``("__trace__", events)`` frame (clock-
        offset corrected) instead of handing it to a caller."""
        if isinstance(obj, tuple) and len(obj) == 2 and \
                obj[0] == "__trace__":
            obs_trace.absorb(obj[1], self._trace_offset)
            return True
        return False

    def _recv(self, timeout, what):
        """One message, polling peer liveness while waiting."""
        if self._stash:
            return self._stash.popleft()
        limit = timeout if timeout is not None else self.call_timeout
        deadline = time.monotonic() + limit
        while True:
            try:
                if self._conn.poll(self._POLL_S):
                    kind, obj = self._decode_frame(
                        self._conn.recv_bytes(), what)
                    if kind == "msg" and not self._absorb_if_trace(obj):
                        return obj
                    continue
            except (EOFError, OSError):
                raise self._died(what)
            if not self._peer_alive():
                # drain a reply that raced the exit before declaring death
                try:
                    while self._conn.poll(0):
                        kind, obj = self._decode_frame(
                            self._conn.recv_bytes(), what)
                        if kind == "msg" and not self._absorb_if_trace(obj):
                            return obj
                except (EOFError, OSError) as e:
                    _log.debug("actor '%s': connection drained after peer "
                               "exit during %s: %r", self.name, what, e)
                raise self._died(what)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"actor '{self.name}' gave no reply to {what} within "
                    f"{limit}s (peer still alive)")

    def _encode(self, msg, deadline, what):
        """(frame, payload bytes); a full shm ring retries the slot
        acquisition without redoing the planning."""
        prep = self._codec.prepare(msg)
        nbytes = prep.size if isinstance(prep, wire.Planned) else len(prep)
        while True:
            try:
                return self._codec.encode_prepared(prep), nbytes
            except _RingFull:
                # every slot is in flight: pump the connection until the
                # receiver acks one (replies read here are stashed)
                self._pump_frame(deadline, f"shm ack for {what}")

    def _send(self, msg, what):
        deadline = time.monotonic() + self.call_timeout
        t = obs_trace.tracer()
        if t is None:
            frame, _ = self._encode(msg, deadline, what)
            try:
                self._conn.send_bytes(frame)
            except (BrokenPipeError, OSError):
                raise self._died(what)
            return
        with t.span("serialize", "wire", actor=self.name) as sp:
            frame, nbytes = self._encode(msg, deadline, what)
            sp.set(bytes=nbytes)
        with t.span("transfer", "wire", actor=self.name, bytes=nbytes):
            try:
                self._conn.send_bytes(frame)
            except (BrokenPipeError, OSError):
                raise self._died(what)

    def _pump_frame(self, deadline, what):
        """Process exactly one incoming frame: acks release tx slots,
        replies are stashed for the ``_recv`` waiting on them."""
        while True:
            try:
                if self._conn.poll(self._POLL_S):
                    kind, obj = self._decode_frame(
                        self._conn.recv_bytes(), what)
                    if kind == "msg" and not self._absorb_if_trace(obj):
                        self._stash.append(obj)
                    return
            except (EOFError, OSError):
                raise self._died(what)
            if not self._peer_alive():
                raise self._died(what)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"actor '{self.name}': no {what} within "
                    f"{self.call_timeout}s")

    def _next_seq(self) -> int:
        seq = self._seq
        self._seq += 1
        return seq

    # ----------------------------------------------------------- endpoints --

    def call(self, method, args=(), kwargs=None, timeout=None):
        if self._closed:
            raise ActorDied(f"actor '{self.name}' is closed")
        t = obs_trace.tracer()
        sp = obs_trace.NOOP_SPAN if t is None \
            else t.span(f"rpc:{method}", "rpc", actor=self.name)
        with sp:
            # traced frames carry a flow id as a 6th element (the child's
            # serve span binds it); untraced frames keep 5
            fid = t.flow_start() if t is not None else None
            with self._lock:
                seq = self._next_seq()
                msg = (seq, "call", method, tuple(args), kwargs or {})
                self._send(msg if fid is None else msg + (fid,),
                           what=f"call '{method}'")
                try:
                    _, status, payload = self._reply_for(
                        seq, timeout, what=f"call '{method}'")
                except TimeoutError:
                    # the child may still answer: discard that late reply
                    # instead of handing it to the next call
                    self._abandoned.add(seq)
                    raise
        if status == "err":
            raise _unpack_exc(payload, self.name)
        return payload

    def _reply_for(self, seq, timeout, what):
        """The reply to ``seq``, draining stale replies on the way: a
        failed cast's error notice (surfaced as this call's error, after
        this call's own reply is consumed) and the late reply to a call
        whose caller timed out (discarded)."""
        cast_error = None
        while True:
            rseq, status, payload = self._recv(timeout, what=what)
            if rseq == seq:
                if cast_error is not None:   # FIFO: the cast failed first
                    return rseq, "err", cast_error
                return rseq, status, payload
            if rseq in self._abandoned:
                self._abandoned.discard(rseq)
                continue
            if status == "err" and rseq < seq:
                if cast_error is None:
                    cast_error = payload
                continue
            raise RuntimeError(
                f"actor '{self.name}': unexpected stale reply "
                f"{rseq}/{status!r} while waiting for {seq}")

    def cast(self, method, args=(), kwargs=None):
        if self._closed:
            raise ActorDied(f"actor '{self.name}' is closed")
        t = obs_trace.tracer()
        sp = obs_trace.NOOP_SPAN if t is None \
            else t.span(f"cast:{method}", "rpc", actor=self.name)
        with sp:
            fid = t.flow_start() if t is not None else None
            with self._lock:
                seq = self._next_seq()
                msg = (seq, "cast", method, tuple(args), kwargs or {})
                self._send(msg if fid is None else msg + (fid,),
                           what=f"cast '{method}'")

    # --------------------------------------------------------------- trace --

    def _clock_sync(self, rounds: int = 3):
        """Clock-offset handshake at spawn: best of ``rounds`` round
        trips, keeping the offset of the shortest (midpoint estimate:
        child clock + offset == our trace epoch).  Absorbed child events
        are shifted by it, putting every process on one timeline.  A
        no-op unless tracing is on."""
        t = obs_trace.tracer()
        if t is None:
            return
        best_rtt = None
        for _ in range(max(1, rounds)):
            with self._lock:
                seq = self._next_seq()
                t0 = obs_trace.now()
                self._send((seq, "trace_sync", "", (), {}),
                           what="trace_sync")
                _, _, child_t = self._reply_for(seq, 10.0, what="trace_sync")
            t1 = obs_trace.now()
            rtt = t1 - t0
            if best_rtt is None or rtt < best_rtt:
                best_rtt = rtt
                self._trace_offset = (t0 + t1) / 2.0 - child_t
        t.instant(f"clock-sync:{self.name}", "rpc",
                  offset_s=self._trace_offset, rtt_s=best_rtt)

    def drain_trace(self) -> int:
        """Pull the child's buffered trace events now (call replies carry
        them anyway; this flushes a quiet child).  Returns the count."""
        t = obs_trace.tracer()
        if t is None or self._closed:
            return 0
        with self._lock:
            seq = self._next_seq()
            self._send((seq, "drain_trace", "", (), {}), what="drain_trace")
            _, _, payload = self._reply_for(seq, None, what="drain_trace")
        obs_trace.absorb(payload, self._trace_offset)
        return len(payload)

    def healthy(self) -> bool:
        return not self._closed and self._peer_alive()

    def close(self):
        """Graceful shutdown, then teardown.  Idempotent."""
        if self._closed:
            self._teardown()
            return
        self._closed = True
        try:
            with self._lock:
                seq = self._next_seq()
                self._send((seq, "shutdown", "", (), {}), what="shutdown")
                self._reply_for(seq, 10.0, what="shutdown ack")
        except (ActorDied, TimeoutError, OSError, RuntimeError) as e:
            # best effort: the peer may be gone already
            _log.debug("actor '%s': shutdown not acknowledged (%s: %s)",
                       self.name, type(e).__name__, e)
        self._teardown()

    def _teardown(self):
        raise NotImplementedError


def _reap(proc):
    """Join a child, escalating to terminate and then kill."""
    if proc.is_alive():
        proc.join(timeout=5.0)
    if proc.is_alive():
        proc.terminate()
        proc.join(timeout=5.0)
    if proc.is_alive():                      # pragma: no cover - last resort
        proc.kill()
        proc.join(timeout=5.0)


class ProcTransport(_RpcTransport):
    """Hosts the executor in a spawned child (always ``spawn``: the parent
    may hold a live CUDA context, which ``fork`` cannot carry).  The
    factory and its arguments are pickled to the child, the executor is
    built there, and every endpoint travels a Unix socket pair as wire
    payloads.  ``device_spec`` gives the child its own cards."""

    def __init__(self, factory, args=(), kwargs=None, *,
                 spawn_timeout: float = 180.0, call_timeout: float = 600.0,
                 device_spec: Optional[DeviceSpec] = None):
        ctx = mp.get_context("spawn")
        mine, theirs = socketlib.socketpair()
        self._proc = ctx.Process(
            target=_proc_actor_main,
            args=(theirs, factory, tuple(args), kwargs or {},
                  self._make_boot(device_spec)),
            daemon=True, name=f"actor-{getattr(factory, '__name__', '?')}")
        self._init_rpc(_SockConn(mine), self._make_codec(), call_timeout)
        try:
            self._proc.start()
        finally:
            theirs.close()                   # the parent keeps one end
        self._handshake(spawn_timeout, factory)

    def _make_boot(self, device_spec) -> Dict[str, Any]:
        return {"device_spec": device_spec, "apply_device_env": True,
                "trace": obs_trace.enabled()}

    def _make_codec(self):
        return _PlainCodec()

    def _peer_alive(self) -> bool:
        return self._proc.is_alive()

    def _exit_desc(self) -> str:
        return (f"process (pid {self._proc.pid}) exited with code "
                f"{self._proc.exitcode}")

    def join(self, timeout: Optional[float] = None):
        self._proc.join(timeout)

    def _teardown(self):
        self._closed = True
        if self._proc.pid is not None:
            _reap(self._proc)
        self._codec.close()
        self._conn.close()


class ShmTransport(ProcTransport):
    """``ProcTransport`` with a shared-memory data plane.

    Control messages stay on the socket; a payload whose serialized size
    reaches ``threshold`` bytes is written into a shm ring slot instead
    and only ``(slot, segment, nbytes)`` crosses.  The parent -> child
    ring (``slots`` slots) grows its slots to fit (weights); the child ->
    parent ring is half as many fixed segments of ``slot_bytes``
    (batches), and a larger reply (a trainer's weights) goes inline.  An
    argument left at None reads ``REPRO_SHM_THRESHOLD``,
    ``REPRO_SHM_SLOTS`` or ``REPRO_SHM_SLOT_BYTES``, then the default.
    Every segment is created and unlinked by the parent."""

    def __init__(self, factory, args=(), kwargs=None, *,
                 spawn_timeout: float = 180.0, call_timeout: float = 600.0,
                 device_spec: Optional[DeviceSpec] = None,
                 threshold: Optional[int] = None,
                 slots: Optional[int] = None,
                 slot_bytes: Optional[int] = None):
        self._threshold = threshold if threshold is not None else int(
            os.environ.get("REPRO_SHM_THRESHOLD", SHM_THRESHOLD_DEFAULT))
        n_slots = slots if slots is not None else int(
            os.environ.get("REPRO_SHM_SLOTS", SHM_SLOTS_DEFAULT))
        child_bytes = slot_bytes if slot_bytes is not None else int(
            os.environ.get("REPRO_SHM_SLOT_BYTES", SHM_SLOT_BYTES_DEFAULT))
        # the child's segments exist before the child does; it only
        # attaches, so the unlink duty stays here
        self._child_tx_segs = [_shm_create(child_bytes)
                               for _ in range(max(2, n_slots // 2))]
        self._tx_ring = _ShmRing(max(2, n_slots), grow=True,
                                 min_bytes=self._threshold * 4)
        try:
            super().__init__(factory, args, kwargs,
                             spawn_timeout=spawn_timeout,
                             call_timeout=call_timeout,
                             device_spec=device_spec)
        except BaseException:
            self._unlink_segments()
            raise

    def _make_boot(self, device_spec) -> Dict[str, Any]:
        boot = super()._make_boot(device_spec)
        boot["shm"] = {
            "child_tx_names": [s.name for s in self._child_tx_segs],
            "threshold": self._threshold,
        }
        return boot

    def _make_codec(self):
        return _ShmCodec(self._tx_ring, self._threshold,
                         rx_fixed={s.name: s for s in self._child_tx_segs})

    def segment_names(self) -> List[str]:
        """Every live segment this transport owns (for leak checks)."""
        with _SHM_REGISTRY_LOCK:
            live = set(_SHM_REGISTRY)
        return [s.name for s in self._child_tx_segs + self._tx_ring.created
                if s.name in live]

    def _unlink_segments(self):
        for seg in self._child_tx_segs + self._tx_ring.created:
            _shm_unlink(seg)

    def _teardown(self):
        super()._teardown()                  # joins the child, closes codec
        self._unlink_segments()


# ------------------------------------------------------------ socket plane --

def _serve_socket_actor(conn: _SockConn, *, apply_device_env: bool = False):
    """One accepted connection is one actor: read the spawn request, then
    run the server loop until shutdown or EOF."""
    try:
        req = wire.deserialize(conn.recv_bytes())
    except (EOFError, OSError):
        conn.close()
        return
    # tracing controllers append a boot-extras dict (a --listen host has
    # no inherited REPRO_TRACE, so the flag rides the request)
    tag, factory, args, kwargs, spec, *rest = req
    if tag != "spawn":
        conn.close()
        raise ValueError(f"bad socket hello {tag!r}")
    boot = {"device_spec": spec, "apply_device_env": apply_device_env}
    if rest:
        boot.update(rest[0])
    try:
        _actor_server(conn, factory, args, kwargs, boot)
    finally:
        conn.close()


def serve_actor_host(host: str = "0.0.0.0", port: int = 0, *,
                     once: bool = False, ready=None):
    """Actor host: accept connections and serve one actor per connection,
    each on its own thread, until killed (``once``: the first only).
    ``ready(port)`` is told the bound port.  This is what ``python -m
    repro_torch.launch.train --listen HOST:PORT`` runs; the host's own
    cards (``CUDA_VISIBLE_DEVICES`` at launch) are every actor's."""
    ls = socketlib.socket()
    ls.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
    ls.bind((host, port))
    ls.listen(16)
    if ready is not None:
        ready(ls.getsockname()[1])
    try:
        while True:
            sock, peer = ls.accept()
            t = threading.Thread(
                target=_serve_socket_actor, args=(_SockConn(sock),),
                daemon=True, name=f"actor-host-{peer}")
            t.start()
            if once:
                t.join()
                return
    finally:
        ls.close()


def _socket_host_once(report_conn, device_spec):
    """Self-host helper child: bind an ephemeral localhost port, report
    it, serve exactly one actor.  A fresh spawned interpreter, so the
    device spec still applies."""
    if device_spec is not None:
        device_spec.apply_env()
    ls = socketlib.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    report_conn.send(ls.getsockname()[1])
    report_conn.close()
    sock, _ = ls.accept()
    ls.close()
    _serve_socket_actor(_SockConn(sock), apply_device_env=False)


class SocketTransport(_RpcTransport):
    """The wire format over TCP: an executor on an independently launched
    host (``--listen``), or -- with no address -- a self-hosted helper
    process serving one actor on an ephemeral localhost port.  A dropped
    connection or a killed host surfaces as ``ActorDied``."""

    def __init__(self, factory, args=(), kwargs=None, *,
                 address: Optional[Tuple[str, int]] = None,
                 spawn_timeout: float = 180.0, call_timeout: float = 600.0,
                 device_spec: Optional[DeviceSpec] = None):
        self._proc = None
        self.address = address
        if address is None:
            ctx = mp.get_context("spawn")
            pconn, cconn = ctx.Pipe()
            self._proc = ctx.Process(
                target=_socket_host_once, args=(cconn, device_spec),
                daemon=True,
                name=f"sockhost-{getattr(factory, '__name__', '?')}")
            self._proc.start()
            cconn.close()
            if not pconn.poll(spawn_timeout):
                self._proc.kill()
                self._proc.join(5.0)
                raise TimeoutError("socket self-host never reported a port")
            self.address = ("127.0.0.1", pconn.recv())
            pconn.close()
        sock = socketlib.create_connection(self.address,
                                           timeout=spawn_timeout)
        self._init_rpc(_SockConn(sock), _PlainCodec(), call_timeout)
        req = ("spawn", factory, tuple(args), kwargs or {}, device_spec)
        if obs_trace.enabled():
            req = req + ({"trace": True},)
        self._conn.send_bytes(wire.serialize(req))
        self._handshake(spawn_timeout, factory)

    def _peer_alive(self) -> bool:
        # a dead remote peer shows as EOF on the next poll; a self-hosted
        # helper's process can be watched directly
        if self._proc is not None:
            return self._proc.is_alive()
        return True

    def _exit_desc(self) -> str:
        if self._proc is not None:
            return (f"self-hosted process (pid {self._proc.pid}) exited "
                    f"with code {self._proc.exitcode}")
        return f"connection to {self.address} dropped"

    def join(self, timeout: Optional[float] = None):
        if self._proc is not None:
            self._proc.join(timeout)

    def _teardown(self):
        self._closed = True
        if self._proc is not None:
            _reap(self._proc)
        self._codec.close()
        self._conn.close()


def close_all_actors():
    """Close every live remote actor (teardown hygiene) and unlink any shm
    segment a crashed transport left registered."""
    for t in list(_LIVE_TRANSPORTS):
        t.close()
    with _SHM_REGISTRY_LOCK:
        leaked = list(_SHM_REGISTRY.values())
    for seg in leaked:                       # pragma: no cover - backstop
        _shm_unlink(seg)


# ------------------------------------------------------------------ handles --

class ActorHandle:
    """What the controller holds: typed endpoints over a transport.
    Identity is the handle object: ``as_handle`` returns one canonical
    handle per in-process executor, so membership checks keep working."""

    def __init__(self, transport: Transport):
        self.transport = transport
        d = transport.describe()
        self.name: str = d["name"]
        self.role: str = d["role"]
        self.chunk_hooks: bool = d["chunk_hooks"]
        self.engine_hooks: bool = d["engine_hooks"]
        self.staged_weights: bool = d["staged_weights"]
        self._pinned_hooks: bool = d["pinned_hooks"]

    @property
    def device(self):
        """The in-process executor's device (the fabric transfers once
        per target); None for a remote actor."""
        return self.transport.device

    @property
    def remote(self) -> bool:
        """True when the actor lives in another process."""
        return self.transport.remote

    def call(self, method: str, *args, timeout: Optional[float] = None,
             **kwargs):
        """Synchronous endpoint: invoke a method (or read an attribute) on
        the actor and return the result; remote exceptions re-raise
        here.  ``timeout`` bounds a remote call's wait."""
        return self.transport.call(method, args, kwargs, timeout)

    def cast(self, method: str, *args, **kwargs):
        """Fire-and-forget send, in order with later calls through this
        handle; a remote error surfaces on the next ``call``."""
        self.transport.cast(method, args, kwargs)

    def healthy(self) -> bool:
        return self.transport.healthy()

    def drain_trace(self) -> int:
        """Pull this actor's buffered trace events (remote only)."""
        return self.transport.drain_trace()

    def join(self, timeout: Optional[float] = None):
        self.transport.join(timeout)

    def close(self):
        self.transport.close()

    def respawn(self) -> "ActorHandle":
        """Rebuild this actor from its recorded spawn spec, swapping the
        fresh transport in place.

        Identity is the handle object, so every structure holding it --
        pools, weight channels, controller maps -- follows the respawn.
        The old transport is closed first, which joins the dead process
        (its CUDA context is gone before the new child allocates) and
        unlinks the shm segments the parent made for it; the new executor
        starts blank (``init`` and the weight replay are the supervisor's
        job)."""
        spec = getattr(self, "spawn_spec", None)
        if spec is None:
            raise RuntimeError(
                f"actor '{self.name}' has no recorded spawn spec "
                "(not created via spawn_actor?)")
        try:
            self.transport.close()
        except Exception as e:               # pragma: no cover - diagnostics
            _log.debug("closing dead transport for '%s': %r", self.name, e)
        t = spec.build()
        self.transport = t
        d = t.describe()
        self.name = d["name"]
        self.role = d["role"]
        self.chunk_hooks = d["chunk_hooks"]
        self.engine_hooks = d["engine_hooks"]
        self.staged_weights = d["staged_weights"]
        self._pinned_hooks = d["pinned_hooks"]
        return self

    # -- chunk-stepping collaborator surface (RolloutScheduler) -------------
    # The scheduler calls advance_chunk(job, state), which mutates the job
    # in place.  The handle routes through advance_chunk_rt, which returns
    # the job, and mirrors its fields back onto the caller's job: in
    # process that is the identity; over a process boundary it carries the
    # key split and chunk count home.  A remote generator pins the
    # admission-time params on its side (``begin_batch_pinned``), so the
    # job carries a small reference instead of the weights every chunk.

    def begin_batch(self, batch_index=None):
        if self.transport.remote and self._pinned_hooks:
            return self.call("begin_batch_pinned", batch_index)
        return self.call("begin_batch", batch_index)

    def advance_chunk(self, job, state):
        job2, state = self.call("advance_chunk_rt", job, state)
        if job2 is not job:
            job.__dict__.update(job2.__dict__)
        return state

    def emit_batch(self, job, state):
        return self.call("emit_batch", job, state)

    def __repr__(self):
        kind = type(self.transport).__name__
        return f"<ActorHandle {self.name!r} role={self.role} via {kind}>"


def as_handle(x) -> ActorHandle:
    """Canonical handle for ``x``: handles pass through; a raw executor
    gets one cached in-process handle."""
    if isinstance(x, ActorHandle):
        return x
    h = getattr(x, "_actor_handle", None)
    if h is None:
        h = ActorHandle(InprocTransport(x))
        x._actor_handle = h
    return h


_SOCKET_ADDR_COUNTER = [0]
_SOCKET_ADDR_LOCK = threading.Lock()


def _next_socket_address() -> Optional[Tuple[str, int]]:
    """Round-robin over ``REPRO_SOCKET_ADDRS`` ("host:port,host:port");
    None (self-host) when unset."""
    addrs = os.environ.get("REPRO_SOCKET_ADDRS", "").strip()
    if not addrs:
        return None
    parts = [a.strip() for a in addrs.split(",") if a.strip()]
    with _SOCKET_ADDR_LOCK:
        pick = parts[_SOCKET_ADDR_COUNTER[0] % len(parts)]
        _SOCKET_ADDR_COUNTER[0] += 1
    host, _, port = pick.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _check_transport(transport: str) -> str:
    if transport not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {transport!r}: expected one of "
            f"{', '.join(TRANSPORTS)}")
    return transport


def _inproc_mesh(spec: Optional[DeviceSpec], kwargs):
    """An in-process actor's kwargs with its mesh, built from this
    process's world, when ``spec`` asks for one."""
    if spec is None or not spec.mesh_shape or "mesh" in kwargs:
        return kwargs
    return dict(kwargs, mesh=spec.build_mesh(_mesh_device_type(kwargs)))


@dataclass(frozen=True)
class SpawnSpec:
    """How an actor was built: the factory, its arguments, the transport,
    the child's devices and the socket address, recorded on the handle by
    ``spawn_actor`` so the actor can be rebuilt identically
    (``ActorHandle.respawn``)."""

    factory: Any
    args: Tuple = ()
    kwargs: Any = None
    transport: str = "inproc"
    spawn_timeout: float = 180.0
    call_timeout: float = 600.0
    device_spec: Optional[DeviceSpec] = None
    address: Optional[Tuple[str, int]] = None

    def build(self) -> Transport:
        """A fresh transport hosting a newly constructed executor."""
        kwargs = dict(self.kwargs or {})
        transport = _check_transport(self.transport)
        if transport == "inproc":
            return InprocTransport(self.factory(
                *self.args, **_inproc_mesh(self.device_spec, kwargs)))
        common = dict(spawn_timeout=self.spawn_timeout,
                      call_timeout=self.call_timeout,
                      device_spec=self.device_spec)
        if transport == "proc":
            return ProcTransport(self.factory, self.args, kwargs, **common)
        if transport == "shm":
            return ShmTransport(self.factory, self.args, kwargs, **common)
        return SocketTransport(self.factory, self.args, kwargs,
                               address=self.address, **common)

    def spawn(self) -> ActorHandle:
        """A fresh handle over a newly built transport."""
        h = ActorHandle(self.build())
        h.spawn_spec = self
        return h


def spawn_all(jobs, at_once: bool = True) -> list:
    """What each of ``jobs`` returns (callables that spawn actors: a
    handle, or a tuple or list holding handles), run at once on threads
    when ``at_once`` -- a spawned child takes seconds to import torch and
    open its CUDA context -- else in order.  If one fails, every actor
    the others spawned is closed and the first error is raised once all
    have returned."""
    if not at_once:
        return [job() for job in jobs]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max(1, len(jobs)),
                            thread_name_prefix="spawn") as ex:
        futures = [ex.submit(job) for job in jobs]
    out, failed = [], None
    for f in futures:
        try:
            out.append(f.result())
        except BaseException as e:          # re-raised once all are read
            failed = failed or e
    if failed is not None:
        _close_spawned(out)
        raise failed
    return out


def _close_spawned(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            _close_spawned(y)
    elif hasattr(x, "close"):
        x.close()


def spawn_actor(factory, *args, transport: Optional[str] = None,
                spawn_timeout: float = 180.0, call_timeout: float = 600.0,
                device_spec: Optional[DeviceSpec] = None,
                address: Optional[Tuple[str, int]] = None,
                **kwargs) -> ActorHandle:
    """Construct an executor behind an ``ActorHandle``.

    ``transport`` is ``"inproc"`` (built here, direct calls), ``"proc"``
    (a spawned child, wire payloads over a socket pair), ``"shm"`` (the
    same, large payloads over shared-memory rings) or ``"socket"`` (TCP to
    ``address``, a ``--listen`` host; with no address the next of
    ``REPRO_SOCKET_ADDRS``, else a self-hosted local helper); ``None``
    reads ``REPRO_TRANSPORT`` (default ``inproc``).  ``device_spec`` gives
    a spawned child its cards.  The spec is recorded as
    ``handle.spawn_spec``."""
    transport = _check_transport(
        transport or os.environ.get("REPRO_TRANSPORT", "inproc"))
    if transport == "socket" and address is None:
        address = _next_socket_address()
    spec = SpawnSpec(factory, tuple(args), dict(kwargs), transport,
                     spawn_timeout, call_timeout, device_spec, address)
    if transport != "inproc":
        return spec.spawn()
    # the identity-caching as_handle path: wiring sites that name the
    # same raw executor share one canonical handle
    h = as_handle(factory(*args, **_inproc_mesh(device_spec, kwargs)))
    h.spawn_spec = spec
    return h
