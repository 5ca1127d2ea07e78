"""The port's launcher (``repro_torch.launch.train``) on the CPU: with
``--transport proc`` it trains what ``--transport inproc`` trains, bit for
bit; from the same converted init it tracks the JAX package's
``repro.launch.train --arch llama31-8b --smoke`` within 1e-4; the flags of
pieces not ported yet raise naming their ROADMAP item; ``--supervise``,
``--max-restarts``, ``--chaos`` (and ``REPRO_CHAOS``) build the supervisor,
a chaos kill is respawned or, with no restarts left, degrades the pool;
``--checkpoint-every`` writes the trainer's files; ``--listen`` serves
actors to a ``--connect`` controller on localhost; ``--out`` and
``--trace`` write their files.

The bit-for-bit cases run torch on one CPU thread in every process (see
``tests/test_torch_actors.py``)."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core import DeviceSpec, close_all_actors
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("loss", "grad_norm", "mean_ratio", "mean_logp", "mean_reward",
        "weight_version", "sample_staleness", "generator")
SMOKE = ["--arch", "llama31-8b", "--smoke", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _reap_actors():
    yield
    close_all_actors()


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def rows(history):
    return [[h[k] for k in KEYS] for h in history]


def test_proc_equals_inproc(one_thread):
    argv = SMOKE + ["--steps", "3", "--kl-coef", "0.1", "--rollout-chunk",
                    "4"]
    hi = train.run(train.parse_args(argv + ["--transport", "inproc"]))
    args = train.parse_args(argv + ["--transport", "proc"])
    ctl = train.build_controller(train.config_for(args), args)
    # the trainer, generator and reference run in children, the reward
    # here
    assert sorted(n for n, h in ctl.executors.items() if h.remote) == [
        "generator", "ref", "trainer"]
    hp = ctl.run()
    assert rows(hp) == rows(hi["history"])
    assert [h["weight_version"] for h in hp] == [0, 0, 1]


def test_build_controller_takes_executor_factories():
    from repro_torch.core import (GeneratorExecutor, RefPolicyExecutor,
                                  TrainerExecutor)

    class Trainer(TrainerExecutor):
        pass

    class Generator(GeneratorExecutor):
        pass

    class Ref(RefPolicyExecutor):
        pass
    args = train.parse_args(SMOKE + ["--steps", "1", "--kl-coef", "0.1",
                                     "--transport", "inproc"])
    ctl = train.build_controller(train.config_for(args), args,
                                 trainer_cls=Trainer, generator_cls=Generator,
                                 ref_cls=Ref)
    built = {n: type(h.transport.executor)
             for n, h in ctl.executors.items()}
    assert (built["trainer"], built["generator"], built["ref"]) == (
        Trainer, Generator, Ref)
    assert [h["weight_version"] for h in ctl.run()] == [0]


def test_tracks_the_jax_launcher():
    import argparse

    import jax
    import jax.numpy as jnp

    from repro.configs.llama_paper import smoke as jsmoke
    from repro.launch import train as jtrain
    from repro.train.trainstep import init_train_state as jinit_state
    from repro_torch import convert
    from repro_torch.train.optimizer import adam_init
    from repro_torch.train.trainstep import TrainState

    args = train.parse_args(SMOKE + ["--steps", "3", "--transport",
                                     "inproc"])
    # the port's flags are the JAX launcher's: its namespace serves both
    jargs = argparse.Namespace(**vars(args))
    jcfg = jsmoke()
    jh = jtrain.build_controller(jcfg, jargs).run()
    jparams = jax.device_get(
        jinit_state(jcfg, jax.random.PRNGKey(0), jnp.float32).params)
    ctl = train.build_controller(train.config_for(args), args)
    trn = ctl.trainer.transport.executor

    def init_from_jax():
        params = convert.from_jax_numpy(jparams, device="cpu")
        trn.state = TrainState(params, adam_init(params))
        trn.set_output("policy_model", params)
    trn.init = init_from_jax
    th = ctl.run()
    assert len(jh) == len(th) == 3
    for j, t in zip(jh, th):
        for k in ("step", "weight_version", "sample_staleness",
                  "mean_reward"):
            assert t[k] == j[k], (t["step"], k)
        for k in ("loss", "mean_logp", "mean_ratio", "grad_norm"):
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), \
                (t["step"], k, t[k], j[k])


@pytest.mark.parametrize("flags,item", [
    (["--arch", "xlstm-350m"], "A11"),
    (["--child-mesh", "1x2"], "A12"),
])
def test_unported_flags_raise(flags, item):
    """Flags refused until their ROADMAP item was done now run:
    ``--arch xlstm-350m`` (A11) takes two async steps of its smoke config
    on the CPU with finite metrics, the list of xLSTM layers through the
    trainer and weight sync; ``--child-mesh 1x2`` (A12.6) builds the
    loop with a (1, 2) ``DeviceSpec`` for every spawned child (here the
    actors stay in this process, where a mesh of two ranks cannot be
    built, so the spec is read off the spawn spec; the meshed children
    run in tests/test_torch_child_mesh.py)."""
    if flags[0] == "--arch":
        args = train.parse_args(["--smoke", "--device", "cpu", "--steps",
                                 "2", "--max-new", "4"] + flags)
        cfg = train.config_for(args)
        assert cfg == configs.get_smoke(flags[1]) and cfg.family == "ssm"
        hist = train.build_controller(cfg, args).run()
        assert len(hist) == 2
        assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                   for h in hist)
        return
    args = train.parse_args(["--smoke", "--device", "cpu"] + flags)
    assert item == "A12" and args.child_mesh == "1x2"
    spec = DeviceSpec(mesh_shape=train._parse_mesh(args.child_mesh))
    assert spec.mesh_shape == (1, 2) and spec.mesh_size == 2
    with pytest.raises(ValueError, match="join"):
        # an in-process actor's mesh is this process's world, of one rank
        train.build_controller(train.config_for(args), args)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "command-r-35b",
                                  "deepseek-67b", "nemotron-4-340b",
                                  "llama4-scout-17b-a16e", "llama31-8b"])
def test_arch_flag_reads_the_registry_as_jax(arch):
    """``--arch A --smoke`` gives the JAX package's smoke config of A, and
    ``--arch A`` its full config, as ``repro.launch.train`` reads them;
    the default arch is the reference's, starcoder2-3b."""
    import dataclasses
    from repro import configs as jconfigs
    from repro.configs import llama_paper as jllama
    if arch == "llama31-8b":
        jsmoke, jfull = jllama.smoke(), jllama.LLAMA31_8B
    else:
        jsmoke, jfull = jconfigs.get_smoke(arch), jconfigs.get_config(arch)
    for argv, want in ((["--smoke"], jsmoke), ([], jfull)):
        cfg = train.config_for(train.parse_args(["--arch", arch] + argv))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert train.parse_args([]).arch == "starcoder2-3b"


@pytest.mark.parametrize("flags,faults,restarts", [
    (["--supervise"], [], 3),
    (["--supervise", "--max-restarts", "0"], [], 0),
    (["--chaos", "kill:generator@batch=1"],
     [("kill", "generator", "batch", 1, None)], 3),
    (["--supervise", "--chaos", "hang:generator@batch=2:5;"
      "kill:ref@consume=1"],
     [("hang", "generator", "batch", 2, None),
      ("kill", "ref", "consume", 1, None)], 3),
])
def test_supervision_flags_build_a_supervisor(flags, faults, restarts):
    args = train.parse_args(SMOKE + ["--transport", "inproc"] + flags)
    ctl = train.build_controller(train.config_for(args), args)
    sup = ctl.supervisor
    assert sup is not None and sup.default.max_restarts == restarts
    got = [(f.action, f.actor, f.point, f.index, f.chunk)
           for f in sup.chaos.faults] if sup.chaos is not None else []
    assert got == faults
    assert sup.covers(ctl.generator)


def test_supervise_reads_repro_chaos(monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "kill:generator1@batch=3")
    args = train.parse_args(SMOKE + ["--transport", "inproc", "--supervise"])
    ctl = train.build_controller(train.config_for(args), args)
    assert [(f.actor, f.index) for f in ctl.supervisor.chaos.faults] == \
        [("generator1", 3)]
    args = train.parse_args(SMOKE + ["--transport", "inproc"])
    assert train.build_controller(train.config_for(args),
                                  args).supervisor is None


def test_checkpoint_every_writes_the_trainer(tmp_path):
    ck = tmp_path / "ck"
    out = train.run(train.parse_args(
        SMOKE + ["--steps", "4", "--transport", "inproc",
                 "--checkpoint-every", "2", "--checkpoint-path", str(ck)]))
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3]
    assert sorted(p.name for p in ck.iterdir()) == [
        f"trainer_{n}.{ext}" for n in (1, 3) for ext in ("json", "npz")]
    assert "events" not in out


@pytest.mark.parametrize("chaos,restarts", [
    ("kill:generator1@batch=3,chunk=1", 3),
    ("kill:generator1@batch=3", 0)])
def test_chaos_run_recovers_or_degrades(chaos, restarts, capsys):
    """The chip script's [14] (c) on the CPU: a mid-decode kill under the
    chunk scheduler is respawned; with no restarts left the victim is
    lost and its batches 3 and 5 go to generator0."""
    out = train.main(SMOKE + [
        "--steps", "6", "--transport", "proc", "--n-generators", "2",
        "--rollout-chunk", "2", "--supervise", "--max-restarts",
        str(restarts), "--chaos", chaos])
    printed = capsys.readouterr().out
    assert [h["step"] for h in out["history"]] == list(range(6))
    kinds = [(e["event"], e["actor"]) for e in out["events"]]
    assert "supervisor: {" in printed and "'generator1'" in printed
    producers = [h["generator"] for h in out["history"]]
    if restarts:
        assert ("respawned", "generator1") in kinds
        assert producers == [f"generator{n % 2}" for n in range(6)]
    else:
        assert ("lost", "generator1") in kinds
        assert producers == ["generator0", "generator1"] + \
            ["generator0"] * 4
        assert [e["n_workers"] for e in out["events"]
                if e["event"] == "pool-resized"] == [1]


def test_listen_serves_a_connecting_controller(one_thread, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    host = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--listen",
         "127.0.0.1:0"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        text=True)
    try:
        line = host.stdout.readline()
        assert line.startswith("actor host listening on 127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])
        argv = SMOKE + ["--steps", "2"]
        args = train.parse_args(argv + ["--transport", "socket", "--connect",
                                        f"127.0.0.1:{port}"])
        ctl = train.build_controller(train.config_for(args), args)
        assert ctl.trainer.transport.address == ("127.0.0.1", port)
        assert ctl.generator.transport._proc is not None  # self-hosted
        hs = ctl.run()
        close_all_actors()
        hi = train.run(train.parse_args(argv + ["--transport", "inproc"]))
        assert rows(hs) == rows(hi["history"])
    finally:
        host.kill()
        host.wait(timeout=30)


def test_main_writes_out_and_trace(tmp_path, capsys, monkeypatch):
    from repro_torch.obs import trace as obs_trace
    out, trace = tmp_path / "run.json", tmp_path / "trace.json"
    monkeypatch.setenv(obs_trace.ENV_FLAG, "1")
    was_on = obs_trace.enabled()
    try:
        train.main(SMOKE + ["--steps", "2", "--transport", "inproc",
                            "--out", str(out), "--trace", str(trace)])
    finally:
        if not was_on:
            obs_trace.disable()
    doc = json.loads(out.read_text())
    assert [h["step"] for h in doc["history"]] == [0, 1]
    assert set(doc) == {"history", "stats", "staleness_hist"}
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert "trace: wrote" in capsys.readouterr().out
