"""Communication channels (paper Sec. 5.1.2; the port of the JAX package's
``core/channels.py``).

A channel is a named, directed link between an outbound and an inbound
actor with a communication type:

  BROADCAST / SCATTER / GATHER -- data handed to the inbound executor
  DDMA_WEIGHTS_UPDATE -- model weights moved trainer -> generator by a
                         direct device-to-device transfer (``core.ddma``)
  PS_WEIGHTS_UPDATE   -- the same through host memory (the baseline)

Every hop goes through the inbound actor's transport: ``prepare`` stages
the payload (the DDMA transfer for weights), and delivery lands through
the handle's ``cast`` of ``set_weights`` / ``put_input``.  Weight
payloads travel with their version so the generator can pin the version
the bounded-staleness schedule prescribes.  A ``StagedWeights`` marker
stands for a payload the weight fabric already staged actor-side; its
delivery is the ``commit_weights`` slot flip.

``deliver`` / ``communicate`` are the sequential path; ``send`` /
``recv`` are queue-backed so the two ends can live on different threads,
and ``close()`` wakes a thread blocked in either with ``Closed``.
"""
from __future__ import annotations

import enum
import queue
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.actors import ActorHandle, as_handle
from repro_torch.core.offpolicy import Closed, StalenessBuffer


class StagedWeights:
    """Channel marker for a weight payload the fabric already *staged*
    actor-side (``stage_weights``): delivery through the channel is a
    ``commit_weights`` cast -- the staleness-legal slot flip -- instead
    of the payload itself.  ``on_commit`` (if set) tells the fabric the
    subscriber released a slot."""

    __slots__ = ("version", "on_commit")

    def __init__(self, version: int, on_commit=None):
        self.version = version
        self.on_commit = on_commit

    def __repr__(self):
        return f"<StagedWeights v{self.version}>"


class CommType(enum.Enum):
    BROADCAST = "broadcast"
    SCATTER = "scatter"
    GATHER = "gather"
    DDMA_WEIGHTS_UPDATE = "ddma_weights_update"
    PS_WEIGHTS_UPDATE = "ps_weights_update"   # slow baseline, for benches

    @property
    def is_weights(self) -> bool:
        return self in (CommType.DDMA_WEIGHTS_UPDATE,
                        CommType.PS_WEIGHTS_UPDATE)


@dataclass
class CommunicationChannel:
    name: str
    outbound: ActorHandle
    inbound: ActorHandle
    comm_type: CommType
    capacity: int = 16          # queue depth bound for the threaded path

    def __post_init__(self):
        self.outbound = as_handle(self.outbound)
        self.inbound = as_handle(self.inbound)
        # a delay=0 StalenessBuffer is the closeable bounded FIFO
        self._q = StalenessBuffer(delay=0, max_size=max(0, self.capacity))

    # ------------------------------------------------------ transfer core --

    def _transfer(self, data):
        """Stage the payload toward the inbound actor through its
        transport, on the producer's side."""
        return self.inbound.transport.prepare(data, self.comm_type)

    def _hand_over(self, data, version: Optional[int]):
        if self.comm_type.is_weights:
            if isinstance(data, StagedWeights):
                # the payload already lives in the actor's staged slot
                self.inbound.cast("commit_weights", data.version)
                if data.on_commit is not None:
                    data.on_commit()
            else:
                self.inbound.cast("set_weights", data, version=version)
        else:
            self.inbound.cast("put_input", self.name, data)

    # ----------------------------------------------------- sequential path --

    def deliver(self, data, version: Optional[int] = None):
        """Transfer + hand a given payload to the inbound actor."""
        self._hand_over(self._transfer(data), version)

    def communicate(self, version: Optional[int] = None):
        """Sequential path: pull from the outbound port and deliver."""
        self.deliver(self.outbound.call("get_output", self.name),
                     version=version)

    # ------------------------------------------------------- threaded path --

    def send(self, data, version: Optional[int] = None,
             timeout: Optional[float] = None):
        """Producer side: transfer, then enqueue (blocks when full).
        Raises ``Closed`` once the channel is closed."""
        self.send_transferred(self._transfer(data), version=version,
                              timeout=timeout)

    def send_transferred(self, data, version: Optional[int] = None,
                         timeout: Optional[float] = None):
        """Enqueue an already-transferred payload: the weight fabric runs
        one transfer and fans the result out to every same-target
        channel."""
        try:
            self._q.push(0 if version is None else version,
                         (version, data), timeout=timeout)
        except TimeoutError:
            raise TimeoutError(
                f"channel '{self.name}' full for {timeout}s "
                f"(capacity={self.capacity})")

    def recv(self, timeout: Optional[float] = None):
        """Consumer side: dequeue and deliver.  Returns (version, data);
        raises queue.Empty on timeout, ``Closed`` once the channel is
        closed and drained."""
        try:
            _, (version, data) = self._q.pop_wait(timeout=timeout)
        except TimeoutError:
            raise queue.Empty
        self._hand_over(data, version)
        return version, data

    def drain(self) -> int:
        """Discard every queued payload without delivering it.  Staged
        markers run their ``on_commit`` so the fabric's slot accounting
        never waits on them.  Returns the count."""
        n = 0
        while True:
            try:
                _, (_, data) = self._q.pop_wait(timeout=0)
            except (TimeoutError, Closed):
                return n
            if isinstance(data, StagedWeights) and data.on_commit is not None:
                data.on_commit()
            n += 1

    def close(self):
        """Wake all threads blocked in send/recv with ``Closed``; queued
        payloads stay recv-able.  Idempotent."""
        self._q.close()

    @property
    def closed(self) -> bool:
        return self._q.closed

    def pending(self) -> int:
        return len(self._q)

    def queued_versions(self) -> List[int]:
        """The versions of the queued payloads (a weight channel's
        versions waiting for their worker's drain)."""
        return self._q.versions()

    def resize(self, capacity: int):
        """Change the queue bound; only legal while nothing is queued (a
        fresh buffer would drop the payloads)."""
        if len(self._q):
            raise RuntimeError(
                f"cannot resize channel '{self.name}' with queued payloads")
        self.capacity = max(0, capacity)
        self._q = StalenessBuffer(delay=0, max_size=self.capacity)


def WeightsCommunicationChannel(name, outbound, inbound,
                                comm_type=CommType.DDMA_WEIGHTS_UPDATE):
    """Paper Algorithm 2's WeightsCommunicationChannel constructor."""
    return CommunicationChannel(name, outbound, inbound, comm_type)
