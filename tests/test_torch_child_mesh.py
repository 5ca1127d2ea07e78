"""A child's own mesh (``DeviceSpec.mesh_shape``, ``Executor(mesh=)``,
``--child-mesh``) on gloo ranks on the CPU.

Four meshed actors spawn at once, each a ``proc`` child and the one
other rank it spawns: three trainers and a generator, in fp32.  Each is
held to the same executor without a mesh, built here on one thread as
the children run.  The first trainer runs Llama 4 Scout's smoke config,
of the MoE family, on a (2, 1) mesh with a batch of 3 rows, which the
data axis does not split: its sharded step gathers every leaf whole
over ``data`` and runs every row on both ranks (on a ``model`` axis of
two its step is tensor-parallel since the MoE family's TP; no family
whose step gathers whole there holds these bounds: the VLM's and the
audio model's executors take no patch or frame embeddings, in both
packages, and the zamba2, xlstm, qwen2-vl and seamless smokes' m miss
1e-6 by their clip scale alone: torch's CPU ``vector_norm`` adds a
leaf's squares in fp32 in turn, so the norm of a leaf's two halves, as a
rank on the model axis holds them, differs from the whole leaf's past
fp32 rounding, see tests/test_torch_train.py::
test_cpu_global_norm_of_a_leaf_and_of_its_halves): its one step,
params and m within 1e-6 of each leaf's largest, v within 2e-6, the
bits reported.  The second and the third run llama31's and Llama 4
Scout's smoke configs on a (1, 2) mesh, whose steps there are
tensor-parallel (``models.tp``: partial products summed over the ranks,
each rank its own experts of the MoE, a vocabulary-parallel log-prob):
their one step at tests/test_torch_sharded.py's bounds for such a step
(metrics within 1e-6 relative; m and v within 1e-5 of each leaf's
largest; each leaf's update 99% within 1e-5 of its largest and all
within 0.2 of it).  The generator (llama31's smoke, on a (2, 1) mesh):
its tokens under the same key, equal.  The
first trainer's world of two also carries DDMA onto its mesh and across
``trainer_generator_submeshes``, bit for bit; the generator places
payloads as ``InprocTransport.prepare`` does.  After
``close_all_actors()`` no rank of any mesh is left.  (One step only:
two chained Adam steps lift fp32 noise near eps to lr-sized moves, see
tests/test_torch_sharded.py.)"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from _mesh_actors import MeshGenerator, MeshTrainer
from repro_torch import configs
from repro_torch.configs.llama_paper import smoke
from repro_torch.core import DeviceSpec, close_all_actors, spawn_actor
from repro_torch.core.executor import GeneratorExecutor, TrainerExecutor
from repro_torch.launch import train
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.train.optimizer import tree_leaves

LR = 1e-3
# of each leaf's largest |value|: the sharded step sums the gradient's
# squares shard by shard, so its global norm, and with it the clip scale,
# differs from the one-device norm in the last bits (m shows it, about
# 7e-7); v holds the clipped gradient squared, so twice that
TOL = {"params": 1e-6, "m": 1e-6, "v": 2e-6}
# the tensor-parallel step sums partial products over the ranks, so its
# gradients differ from the one-device step's in their last bits, and
# its global norm with them: tests/test_torch_sharded.py's bounds, m and
# v within 1e-5 of each leaf's largest, an update 99% within 1e-5 of the
# leaf's largest and all within 0.2 of it (Adam lifts an element whose
# gradient is near its eps to a move of about lr whatever its fp32 noise)
TP_TOL = {"m": 1e-5, "v": 1e-5}
UPDATE_TOL, UPDATE_WORST = 1e-5, 0.2
# Llama 4 Scout's smoke: tests/test_torch_sharded.py's bounds for it, m,
# v and 99% of an update within 1e-4, where its reference gradient is at
# least 1e-6 (``G_SIGN`` there: below it Adam's update turns on the
# gradient's last bits; such an element is held to the 0.2 alone)
MOE_TP_TOL = {"m": 1e-4, "v": 1e-4, "update": 1e-4}
MOE_G_SIGN = 1e-6


def _batch(cfg, seed=5, B=4, T=24, prompt=8):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, T), np.float32)
    mask[:, prompt:] = rng.uniform(size=(B, T - prompt)) > 0.1
    return {
        "tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int64)),
        "behavior_logp": torch.as_tensor(
            (rng.uniform(-8, -4, size=(B, T)) * mask).astype(np.float32)),
        "advantages": torch.as_tensor(
            (rng.standard_normal((B, 1)) * mask).astype(np.float32)),
        "mask": torch.as_tensor(mask),
    }


def _gen_kwargs():
    return dict(n_prompts=2, n_per_prompt=2, max_new=6, seed=3,
                device="cpu")


def _one_thread(fn):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshed():
    """The four meshed actors, spawned at once; each is driven, then
    closed, and its ranks' pids kept for the leak check."""
    cfg, tcfg = smoke(), configs.get_smoke("llama4-scout-17b-a16e")
    out, errors = {}, []
    # (key, config, mesh, rows of the batch)
    trainers = [("trainer", tcfg, (2, 1), 3), ("tp", cfg, (1, 2), 4),
                ("moe_tp", tcfg, (1, 2), 4)]

    def trainer(key, c, shape, rows, ddma):
        h = spawn_actor(MeshTrainer, c, lr=LR, seed=0, device="cpu",
                        transport="proc",
                        device_spec=DeviceSpec(mesh_shape=shape))
        h.call("init")
        out[key + "_info"] = h.call("mesh_info")
        h.call("put_input", "completions_with_reward", _batch(c, B=rows))
        out[key + "_metrics"] = h.call("step")
        out[key + "_state"] = h.call("state_whole")
        if ddma:
            out["ddma"] = h.call("ddma_checks")
        out[key + "_h"] = h

    def generator():
        h = spawn_actor(MeshGenerator, cfg, ArithmeticTasks(seed=1),
                        transport="proc", **_gen_kwargs(),
                        device_spec=DeviceSpec(mesh_shape=(2, 1)))
        h.call("set_weights", out_params, version=0)
        out["gen_info"] = h.call("mesh_info")
        out["tokens"] = h.call("step")["tokens"]
        out["placement"] = h.call("placement_checks", {
            "x": torch.arange(24.0).reshape(6, 4), "n": torch.tensor(3.0)})
        out["gen_h"] = h

    from repro_torch.models import init_params
    out_params = init_params(cfg, 7, torch.float32, device="cpu")

    def run(fn, *args):
        try:
            fn(*args)
        except BaseException as e:          # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(
        trainer, key, c, shape, rows, key == "trainer"))
        for key, c, shape, rows in trainers]
    threads.append(threading.Thread(target=run, args=(generator,)))
    for t in threads:
        t.start()
    # the unmeshed twins, here, while the children spawn
    for key, c, _, rows in trainers:
        key = "twin" if key == "trainer" else key + "_twin"
        twin = TrainerExecutor(c, lr=LR, seed=0, device="cpu")
        _one_thread(twin.init)
        out[key + "_init"] = twin.state.params   # Adam makes new params
        twin.put_input("completions_with_reward", _batch(c, B=rows))
        out[key + "_metrics"] = _one_thread(twin.step)
        out[key + "_state"] = twin.state
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=1), **_gen_kwargs())
    gen.set_weights(out_params, version=0)
    out["twin_tokens"] = _one_thread(gen.step)["tokens"]
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive()
    try:
        if errors:
            raise errors[0]
        yield out
    finally:
        close_all_actors()


def _paths(tree, prefix=()):
    """The leaf paths of nested dicts in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield "/".join(prefix)


def _check_info(info, shape=(1, 2)):
    assert info["shape"] == list(shape) and info["axes"] == ["data", "model"]
    assert info["device_type"] == "cpu" and len(set(info["pids"])) == 2


def _check_metrics(got, want):
    for k in ("loss", "grad_norm", "mean_ratio", "mean_logp"):
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k


def test_meshed_trainer_step_equals_the_unmeshed_step(meshed):
    _check_info(meshed["trainer_info"], (2, 1))
    got, want = meshed["trainer_state"], meshed["twin_state"]
    assert got["step"] == want.opt.step == 1
    bits, worst = True, {}
    for part, tree in (("params", want.params), ("m", want.opt.m),
                       ("v", want.opt.v)):
        for a, b in zip(tree_leaves(got[part]), tree_leaves(tree)):
            assert a.shape == b.shape and a.dtype == b.dtype
            bits = bits and torch.equal(a, b)
            rel = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
            worst[part] = max(worst.get(part, 0.0), rel)
            assert rel <= TOL[part], part
    _check_metrics(meshed["trainer_metrics"], meshed["twin_metrics"])
    print(f"meshed trainer bit-equal to the unmeshed one: {bits}; the "
          "largest difference of each leaf's largest: " + ", ".join(
              f"{k} {v:.1e}" for k, v in worst.items()))


def test_meshed_tp_trainer_step_matches_the_unmeshed_step(meshed):
    """The dense family's tensor-parallel step in a child's own (1, 2)
    mesh against the unmeshed step, at the bounds for such a step."""
    _check_tp_step(meshed, "tp", dict(TP_TOL, update=UPDATE_TOL))


def test_meshed_moe_tp_trainer_step_matches_the_unmeshed_step(meshed):
    """The MoE family's tensor-parallel step (Llama 4 Scout's smoke: two
    experts, four of eight query heads and half the vocabulary a rank)
    in a child's own (1, 2) mesh against the unmeshed step, at the
    bounds for such a step."""
    _check_tp_step(meshed, "moe_tp", MOE_TP_TOL, MOE_G_SIGN)


def _check_tp_step(meshed, key, tol, g_sign=0.0):
    """One TP step against the unmeshed one at ``tol``; an update whose
    reference gradient (the unmeshed m over 0.1, Adam's first step) is
    below ``g_sign`` is held to UPDATE_WORST alone."""
    _check_info(meshed[key + "_info"])
    got, want = meshed[key + "_state"], meshed[key + "_twin_state"]
    assert got["step"] == want.opt.step == 1
    init = tree_leaves(meshed[key + "_twin_init"])
    names = list(_paths(want.params))
    grads = [m.abs() / 0.1 for m in tree_leaves(want.opt.m)]
    worst = {}
    for part, tree in (("params", want.params), ("m", want.opt.m),
                       ("v", want.opt.v)):
        for i, (a, b) in enumerate(zip(tree_leaves(got[part]),
                                       tree_leaves(tree))):
            assert a.shape == b.shape and a.dtype == b.dtype
            if part == "params":
                # the update's error past one fp32 ulp of the param, over
                # the leaf's largest update
                big = (b - init[i]).abs().max().item()
                ulp = torch.nextafter(b.abs(), torch.tensor(float("inf"))) \
                    - b.abs()
                err = ((a - b).abs() - ulp).clamp(min=0) / max(big, 1e-30)
                worst[part] = max(worst.get(part, 0.0), err.max().item())
                assert err.max().item() <= UPDATE_WORST, part
                held = grads[i] >= g_sign
                assert (err[held] > tol["update"]).float().mean().item() \
                    <= 0.01, (part, names[i])
                continue
            rel = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
            worst[part] = max(worst.get(part, 0.0), rel)
            assert rel <= tol[part], part
    _check_metrics(meshed[key + "_metrics"], meshed[key + "_twin_metrics"])
    print(f"meshed tensor-parallel trainer ({key}), the largest difference "
          "of each "
          "leaf's largest (params: of its update): " + ", ".join(
              f"{k} {v:.1e}" for k, v in worst.items()))


def test_meshed_generator_tokens_equal_the_unmeshed_ones(meshed):
    info = meshed["gen_info"]
    assert info["shape"] == [2, 1] and len(set(info["pids"])) == 2
    assert torch.equal(meshed["tokens"], meshed["twin_tokens"])


def test_ddma_onto_a_mesh_and_across_submeshes(meshed):
    """Replicated onto the trainer's (2, 1) mesh on both ranks; across
    the submeshes ([0] trains, [1] generates), rank 1 holds rank 0's
    version bit for bit and rank 0 gets None."""
    r0, r1 = meshed["ddma"]
    assert r0["on_mesh"] and r1["on_mesh"]
    assert r0["submeshes"] == r1["submeshes"] == [[0], [1]]
    assert r0["in_trainer"] and r0["carried"] is None
    assert not r1["in_trainer"] and r1["carried"] is True


def test_payload_placement_on_a_mesh(meshed):
    """SCATTER split on dim 0 over the first axis (three rows a rank of
    six), BROADCAST, weights and a 0-d tensor replicated; ``put_input``
    takes the payload whole on every rank."""
    for rank, r in enumerate(meshed["placement"]):
        assert r["scatter"] == [["Shard", 0], ["Replicate", None]], rank
        assert r["scatter_local"] and r["broadcast"] and r["weights"]
        assert r["scalar"] and r["whole_input"]


def test_no_mesh_rank_left_after_close(meshed):
    close_all_actors()
    pids = meshed["trainer_info"]["pids"] + meshed["tp_info"]["pids"] \
        + meshed["moe_tp_info"]["pids"] + meshed["gen_info"]["pids"]
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and any(
            os.path.exists(f"/proc/{p}") for p in pids):
        time.sleep(0.1)
    assert not [p for p in pids if os.path.exists(f"/proc/{p}")]
    assert not meshed["trainer_h"].healthy()
    assert not meshed["tp_h"].healthy()
    assert not meshed["moe_tp_h"].healthy()
    assert not meshed["gen_h"].healthy()


def test_child_mesh_flag_reaches_every_child_spec(monkeypatch):
    """``--child-mesh 1x2`` parses as the reference's ``_parse_mesh`` and
    composes with ``--child-devices``: the trainer, each pool generator
    and the reference get one ``DeviceSpec((2, (1, 2)))``."""
    seen = []
    real_pool = train.build_generator_pool

    def fake_spawn(factory, *args, device_spec=None, **kwargs):
        seen.append(device_spec)
        return factory(*args, **{k: v for k, v in kwargs.items()
                                 if k not in ("transport", "address")})

    def fake_pool(*args, device_spec=None, **kwargs):
        seen.append(device_spec)
        return real_pool(*args, **dict(kwargs, transport="inproc"))

    monkeypatch.setattr(train, "spawn_actor", fake_spawn)
    monkeypatch.setattr(train, "build_generator_pool", fake_pool)
    assert train._parse_mesh("1x4") == (1, 4)
    assert train._parse_mesh("") == ()
    args = train.parse_args(["--smoke", "--device", "cpu", "--kl-coef",
                             "0.1", "--child-mesh", "1x2",
                             "--child-devices", "2"])
    train.build_controller(train.config_for(args), args)
    assert seen == [DeviceSpec(device_count=2, mesh_shape=(1, 2))] * 3
