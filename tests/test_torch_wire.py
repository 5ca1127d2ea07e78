"""The port's wire format (``repro_torch.core.wire``), after
``tests/test_wire_hypothesis.py`` and the wire cases of
``tests/test_actors.py``: random nested payloads of every dtype come back
with their exact bits, non-contiguous, 0-d and empty leaves included;
``serialize_into`` lays out what ``serialize`` does; ``deserialize`` never
aliases its buffer; a CUDA leaf reaching a process without CUDA raises;
and the JAX wire and the port's carry the same payload to the same
bytes."""
import io
import pickle
from dataclasses import dataclass
from typing import NamedTuple

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro_torch.core import wire
from repro_torch.rl.scheduler import RolloutJob

TORCH_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                torch.float8_e4m3fn, torch.float8_e5m2, torch.int8,
                torch.uint8, torch.int16, torch.int32, torch.int64,
                torch.bool]
NP_DTYPES = ["float32", "float64", "int8", "uint8", "int32", "bool", ">i4",
             "<u2", ">f8", "float16", "int64"]


def random_tensor(rng, dtype, shape):
    """A tensor of ``dtype`` and ``shape`` from random bytes, so every bit
    pattern (NaNs, denormals, fp8 specials) is fair game."""
    n = int(np.prod(shape, dtype=np.int64))
    itemsize = torch.empty((), dtype=dtype).element_size()
    raw = rng.integers(0, 256, n * itemsize, dtype=np.uint8)
    if dtype == torch.bool:
        raw = raw & 1
    return torch.from_numpy(raw.copy()).view(dtype).reshape(shape)


def random_array(rng, token, shape):
    dtype = np.dtype(token)
    n = int(np.prod(shape, dtype=np.int64))
    raw = rng.integers(0, 256, n * dtype.itemsize, dtype=np.uint8)
    if dtype == np.bool_:
        raw = raw & 1
    return np.frombuffer(raw.tobytes(), dtype=dtype).reshape(shape).copy()


def random_payload(rng, depth=2):
    """A nested dict / list / tuple of random tensors, arrays and raw
    values."""
    kind = rng.integers(0, 5) if depth else rng.integers(2, 5)
    shape = tuple(int(s) for s in rng.integers(0, 4, rng.integers(0, 4)))
    if kind == 0:
        return {f"k{i}": random_payload(rng, depth - 1)
                for i in range(rng.integers(0, 4))}
    if kind == 1:
        return [random_payload(rng, depth - 1)
                for _ in range(rng.integers(0, 4))]
    if kind == 2:
        dtype = TORCH_DTYPES[rng.integers(len(TORCH_DTYPES))]
        return random_tensor(rng, dtype, shape)
    if kind == 3:
        return random_array(rng, NP_DTYPES[rng.integers(len(NP_DTYPES))],
                            shape)
    return (int(rng.integers(-2**31, 2**31)), "text", None, 1.5)


def assert_same(a, b):
    """Structure equal, every leaf of the same kind, dtype, shape and
    bits."""
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device == b.device
        assert a.contiguous().reshape(-1).view(torch.uint8).numpy() \
            .tobytes() == b.contiguous().reshape(-1).view(torch.uint8) \
            .numpy().tobytes()
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(12))
def test_random_payloads_round_trip_exact_bits(seed):
    rng = np.random.default_rng(seed)
    payload = {"tree": random_payload(rng, depth=3),
               "every_dtype": [random_tensor(rng, d, (3, 2))
                               for d in TORCH_DTYPES]}
    blob = wire.serialize(payload)
    assert len(blob) == wire.plan(payload).size
    assert_same(wire.deserialize(blob), payload)
    assert_same(wire.deserialize(bytes(blob)), payload)   # read-only too


@pytest.mark.parametrize("dtype", TORCH_DTYPES, ids=str)
def test_non_contiguous_zero_d_and_empty_leaves(dtype):
    rng = np.random.default_rng(3)
    base = random_tensor(rng, dtype, (5, 6))
    payload = {"t": base.t(), "step": base[::2, 1::3], "scalar": base[1, 2],
               "empty": base[:0], "empty3": torch.empty((2, 0, 3),
                                                        dtype=dtype)}
    assert not payload["t"].is_contiguous()
    got = wire.deserialize(wire.serialize(payload))
    assert_same(got, payload)
    assert got["scalar"].dim() == 0 and got["empty3"].shape == (2, 0, 3)


def test_empty_batch_and_job_round_trip():
    """A zero-row batch (an empty emit) keeps dtypes and shapes; a
    ``RolloutJob``, a dataclass and a NamedTuple need no registry."""
    batch = {"tokens": torch.zeros((0, 12), dtype=torch.int32),
             "behavior_logp": torch.zeros((0, 12)),
             "mask": torch.zeros((0, 12), dtype=torch.bool),
             "answers": [], "prompt_len": 4}
    assert_same(wire.deserialize(wire.serialize(batch)), batch)
    job = RolloutJob(batch_index=3, params={"w": torch.ones(2)},
                     weight_version=1, key=torch.tensor([7, 9]),
                     meta={"answers": ["12"]}, max_new=8, chunk=4,
                     n_chunks=2)
    got = wire.deserialize(wire.serialize(job))
    assert isinstance(got, RolloutJob) and got.batch_index == 3
    assert torch.equal(got.params["w"], job.params["w"])
    assert torch.equal(got.key, job.key) and got.meta == job.meta
    got = wire.deserialize(wire.serialize(Pair(torch.arange(3), Box(2))))
    assert isinstance(got, Pair) and got.b == Box(2)
    assert torch.equal(got.a, torch.arange(3))


class Pair(NamedTuple):
    a: torch.Tensor
    b: "Box"


@dataclass
class Box:
    n: int


def test_serialize_into_matches_serialize_exact_fit_and_too_small():
    rng = np.random.default_rng(1)
    payload = {"w": random_tensor(rng, torch.bfloat16, (7, 5)).t(),
               "n": random_array(rng, ">i4", (3,)), "meta": ["x", 2]}
    planned = wire.plan(payload)
    exact = bytearray(planned.size)
    assert wire.serialize_into(planned, exact) == planned.size
    assert bytes(exact) == bytes(wire.serialize(payload))
    roomy = bytearray(planned.size + 64)
    wire.serialize_into(planned, memoryview(roomy))
    assert bytes(roomy[:planned.size]) == bytes(exact)
    with pytest.raises(ValueError, match="cannot hold"):
        wire.serialize_into(planned, bytearray(planned.size - 1))


def test_deserialize_never_aliases_its_buffer():
    rng = np.random.default_rng(2)
    payload = {"t": random_tensor(rng, torch.float32, (64,)),
               "a": random_array(rng, "int32", (16,))}
    buf = bytearray(wire.serialize(payload))
    got = wire.deserialize(memoryview(buf))
    buf[:] = bytes(len(buf))                  # the slot is recycled
    assert_same(got, payload)
    got["t"].add_(1)                          # and the leaves are writable
    got["a"] += 1


def _retag_devices(blob, device_type):
    """``blob`` with every tensor entry's device type replaced."""
    mv = memoryview(blob)
    (n,) = wire._LEN.unpack_from(mv, 0)
    entries, body = pickle.loads(mv[8:8 + n])
    entries = [e[:4] + (device_type,) if e[0] == "tensor" else e
               for e in entries]
    manifest = pickle.dumps((entries, body))
    return wire._LEN.pack(len(manifest)) + manifest + bytes(mv[8 + n:])


def test_cuda_leaf_into_a_cuda_less_process_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = _retag_devices(wire.serialize({"w": torch.ones(3),
                                          "n": np.ones(2)}), "cuda")
    with pytest.raises(RuntimeError, match="without CUDA"):
        wire.deserialize(blob)
    # a CPU-tagged leaf stays on the CPU
    got = wire.deserialize(_retag_devices(blob, "cpu"))
    assert got["w"].device.type == "cpu"


def test_manifest_records_each_tensor():
    t = torch.zeros((2, 3), dtype=torch.bfloat16)
    planned = wire.plan({"t": t, "a": np.zeros(4, ">f8")})
    entries, _ = pickle.loads(planned.manifest)
    assert entries[0] == ("tensor", "bfloat16", (2, 3), 12, "cpu")
    assert entries[1] == ("narr", ">f8", (4,), 32)


@pytest.mark.parametrize("seed", range(4))
def test_same_bytes_as_the_jax_wire(seed):
    """One numpy-made payload, round-tripped by the JAX wire as numpy
    leaves and by the port as tensors, comes back byte-identical."""
    rng = np.random.default_rng(seed)
    arrays = {"f32": random_array(rng, "float32", (3, 4)),
              "i8": random_array(rng, "int8", (5,)),
              "i64": random_array(rng, "int64", (2, 2)),
              "bool": random_array(rng, "bool", (6,)),
              "bf16": random_array(rng, "uint16", (4, 3)).view(
                  ml_dtypes.bfloat16),
              "empty": random_array(rng, "float32", (0, 3)),
              "scalar": random_array(rng, "int32", ())}
    back_j = jwire.deserialize(jwire.serialize({"x": arrays, "m": [1, "a"]}))
    as_torch = {k: torch.from_numpy(v.view(np.uint16)).view(torch.bfloat16)
                if k == "bf16" else torch.from_numpy(v.copy())
                for k, v in arrays.items()}
    back_t = wire.deserialize(wire.serialize({"x": as_torch, "m": [1, "a"]}))
    assert back_j["m"] == back_t["m"] == [1, "a"]
    for k, v in arrays.items():
        got = back_t["x"][k]
        assert tuple(got.shape) == back_j["x"][k].shape == v.shape
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() \
            == np.asarray(back_j["x"][k]).tobytes() == v.tobytes(), k


def test_unpickler_sees_only_the_manifest_leaves():
    """The body refers to leaves by index only: a body pickled with a
    persistent id outside the manifest cannot load."""
    f = io.BytesIO()
    p = wire._LeafPickler(f)
    p.dump([torch.ones(1)])
    with pytest.raises(IndexError):
        wire._LeafUnpickler(io.BytesIO(f.getvalue()), []).load()
