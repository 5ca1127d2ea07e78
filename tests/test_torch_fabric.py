"""The port's weight-sync fabric (``repro_torch.core.fabric``): publishing
returns at once and delivers in version order, staged slots stay bounded
until the reader commits, an in-process subscriber skips staging, a
publisher error surfaces on the next publish, ``close`` unblocks a
parked publisher, and blocking mode runs on the caller's thread.  After
``tests/test_fabric.py``'s in-process cases: the staged data-plane path
runs through an in-process transport flagged as remote, as there."""
import threading
import time

import pytest
import torch

from repro_torch.core.actors import ActorHandle, InprocTransport, as_handle
from repro_torch.core.channels import StagedWeights, \
    WeightsCommunicationChannel
from repro_torch.core.executor import Executor
from repro_torch.core.fabric import WeightFabric, payload_key
from repro_torch.core.offpolicy import Closed


class WeightSink(Executor):
    """Records applied weights and versions."""

    def __init__(self, name="sink", delay=0.0):
        super().__init__(name)
        self.delay = delay
        self.params = None
        self.weight_version = -1
        self.applied = []
        self.threads = set()

    def set_weights(self, params, version=None):
        if self.delay:
            time.sleep(self.delay)
        self.params = params
        if version is not None:
            self.weight_version = version
        self.applied.append(version)

    def stage_weights(self, params, version):
        self.threads.add(threading.current_thread().name)
        super().stage_weights(params, version)

    def weights_sum(self) -> float:
        return float(self.params["w"].double().sum())


class _RemoteishTransport(InprocTransport):
    """In-process semantics flagged as remote: drives the fabric's staged
    data-plane path deterministically, no subprocess required."""
    remote = True


def remoteish(ex) -> ActorHandle:
    return ActorHandle(_RemoteishTransport(ex))


class Source(Executor):
    def __init__(self):
        super().__init__("trainer")


def make_fabric(sink_handle, **kw):
    src = as_handle(Source())
    ch = WeightsCommunicationChannel("policy_model", src, sink_handle)
    return WeightFabric([ch], **kw), ch


def payloads_for(ch, value):
    return {payload_key(ch): value}


def test_publish_is_nonblocking_and_version_ordered():
    sink = WeightSink(delay=0.15)
    fab, ch = make_fabric(remoteish(sink), overlap=True, max_staged=8)
    t0 = time.monotonic()
    for v in (1, 2, 3):
        fab.publish(v, payloads_for(ch, {"w": torch.full((4,), float(v))}))
    assert time.monotonic() - t0 < 0.1       # the publisher thread works
    seen = [ch.recv(timeout=10.0)[0] for _ in range(3)]
    fab.flush(10.0)
    assert seen == [1, 2, 3]
    assert sink.applied == [1, 2, 3]         # commits in publication order
    assert sink.weight_version == 3 and sink.weights_sum() == 12.0
    assert sink.staged_versions() == []      # every slot released
    assert sink.threads == {"weight-fabric"}
    assert [v for v, _ in fab.published] == [1, 2, 3]
    assert len(fab.intervals) == 3
    fab.quiesce()
    assert fab._thread is None


def test_staged_slots_bounded_until_reader_commits():
    sink = WeightSink()
    fab, ch = make_fabric(remoteish(sink), overlap=True, max_staged=2)
    try:
        for v in (1, 2, 3, 4):
            fab.publish(v, payloads_for(ch, {"w": torch.full((2,),
                                                             float(v))}))
        deadline = time.monotonic() + 5.0
        while fab.staged_out(ch) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        # the publisher parks at the bound, the consumer untouched
        assert fab.staged_out(ch) == 2
        assert sorted(sink.staged_versions()) == [1, 2]
        assert sink.weight_version == -1
        for expect in (1, 2, 3, 4):
            assert ch.recv(timeout=10.0)[0] == expect
        fab.flush(10.0)
        assert sink.applied == [1, 2, 3, 4]
        assert sink.staged_versions() == []
        stats = fab.subscriber_stats()["sink"]
        assert stats["published"] == 4 and stats["wait_s"] > 0
    finally:
        fab.close()


def test_inproc_subscriber_skips_staging():
    sink = WeightSink()
    fab, ch = make_fabric(as_handle(sink), overlap=True)
    w = {"w": torch.ones(3)}
    fab.publish(1, payloads_for(ch, w))
    version, data = ch.recv(timeout=10.0)
    fab.flush(10.0)
    assert version == 1 and not isinstance(data, StagedWeights)
    assert sink.weight_version == 1 and sink.staged_versions() == []
    assert sink.params["w"] is w["w"]        # shared by reference
    assert sink.threads == set()
    fab.quiesce()


def test_publisher_error_surfaces_on_next_publish():
    class BoomSink(WeightSink):
        def stage_weights(self, params, version):
            raise RuntimeError("stage kaboom")

    fab, ch = make_fabric(remoteish(BoomSink()), overlap=True)
    fab.publish(1, payloads_for(ch, {"w": torch.ones(2)}))
    with pytest.raises(RuntimeError, match="stage kaboom"):
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            fab.publish(2, payloads_for(ch, {"w": torch.ones(2)}))
            time.sleep(0.01)
    fab.close()


def test_close_unblocks_parked_publisher():
    fab, ch = make_fabric(remoteish(WeightSink()), overlap=True,
                          max_staged=1)
    fab.publish(1, payloads_for(ch, {"w": torch.ones(2)}))
    fab.publish(2, payloads_for(ch, {"w": torch.ones(2)}))  # parks
    time.sleep(0.2)
    t0 = time.monotonic()
    fab.close()                              # must not hang on the slot
    assert time.monotonic() - t0 < 5.0
    assert fab._thread is None
    with pytest.raises(Closed):
        fab.publish(3, payloads_for(ch, {"w": torch.ones(2)}))


def test_blocking_mode_runs_on_caller_thread():
    sink = WeightSink()
    fab, ch = make_fabric(remoteish(sink), overlap=False)
    fab.publish(1, payloads_for(ch, {"w": torch.ones(2)}))
    assert fab.pending() == 0 and len(fab.intervals) == 1
    assert fab._thread is None
    assert sink.threads == {threading.current_thread().name}
    assert ch.recv(timeout=1.0)[0] == 1
    assert sink.weight_version == 1


def test_detach_and_reattach_replay_latest():
    """A detached subscriber is skipped; ``add_subscriber`` replays the
    latest published version straight into the actor."""
    a, b = WeightSink("a"), WeightSink("b")
    src = as_handle(Source())
    ch_a = WeightsCommunicationChannel("policy_model", src, a)
    ch_b = WeightsCommunicationChannel("policy_model", src, b)
    fab = WeightFabric([ch_a], overlap=False)
    fab.seed(0, {payload_key(ch_a): {"w": torch.zeros(2)}})
    fab.publish(1, {payload_key(ch_a): {"w": torch.ones(2)}})
    assert fab.add_subscriber(ch_b) == 1
    assert b.weight_version == 1 and ch_b.pending() == 0
    fab.detach(ch_a)
    fab.publish(2, {payload_key(ch_a): {"w": torch.ones(2) * 2}})
    assert ch_a.pending() == 1 and ch_b.pending() == 1
    assert fab.dead_subscribers() == [ch_a]


def _subscriber_error_script(actors, channels, executor, fabric, zeros):
    """Two subscribers, one detached with a given error and one detached
    bare: ``subscriber_error`` is None for a live channel, the error for
    the first, a ``Detached`` naming the channel for the second."""
    class Sink(executor.Executor):
        def set_weights(self, params, version=None):
            self.params = params

    src = actors.as_handle(Sink("trainer"))
    chs = [channels.WeightsCommunicationChannel("policy_model", src,
                                                actors.as_handle(Sink(n)))
           for n in ("a", "b")]
    fab = fabric.WeightFabric(chs, overlap=False)
    try:
        fab.publish(1, {fabric.payload_key(chs[0]): {"w": zeros(2)}})
        log = [fab.subscriber_error(ch) for ch in chs]
        err = RuntimeError("worker lost")
        fab.detach(chs[0], err)
        fab.detach(chs[1])
        e0, e1 = (fab.subscriber_error(ch) for ch in chs)
        log += [e0 is err, type(e1).__name__, str(e1),
                fab.dead_subscribers() == chs]
        fab.detach(chs[0], RuntimeError("again"))      # idempotent
        log.append(fab.subscriber_error(chs[0]) is err)
    finally:
        fab.close()
    return log


def test_subscriber_error_equals_jax():
    """``WeightFabric.subscriber_error``, after ``tests/test_fabric.py``:
    why a subscriber is detached, the same in both packages."""
    import numpy as np
    from repro.core import actors as jactors
    from repro.core import channels as jchannels
    from repro.core import executor as jexecutor
    from repro.core import fabric as jfabric
    from repro_torch.core import actors, channels, executor, fabric
    got = _subscriber_error_script(actors, channels, executor, fabric,
                                   torch.zeros)
    want = _subscriber_error_script(jactors, jchannels, jexecutor, jfabric,
                                    np.zeros)
    assert got == want
    assert got[:3] == [None, None, True] and got[3] == "Detached"
