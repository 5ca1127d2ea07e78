"""The port's checkpoints (``repro_torch.train.checkpoint``) on the CPU,
against the JAX package's ``repro.train.checkpoint``: fp32 and bf16 round
trips are bit-exact; a file the JAX package wrote (bf16 leaves as the
``|V2`` bits ``np.savez`` stores) restores into the port equal to
``convert.from_jax_numpy``; an fp32 file the port wrote restores in the
JAX package; ``checkpoint_every`` writes ``trainer_{step}`` at the
reference's steps; and the ``train_arithmetic_rl`` twin runs two steps
with its last checkpoint equal to the trainer's params."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.llama_paper import smoke as jsmoke
from repro.core import CommType as JCommType
from repro.core import CommunicationChannel as JChannel
from repro.core import ExecutorController as JController
from repro.core import GeneratorExecutor as JGenerator
from repro.core import RewardExecutor as JReward
from repro.core import TrainerExecutor as JTrainer
from repro.core import WeightsCommunicationChannel as JWeights
from repro.models import init_params as jinit_params
from repro.rl.data import ArithmeticTasks as JTasks
from repro.train.checkpoint import restore_checkpoint as jrestore
from repro.train.checkpoint import save_checkpoint as jsave
from repro_torch import convert, train_arithmetic_rl
from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (CommType, CommunicationChannel,
                              ExecutorController, GeneratorExecutor,
                              RewardExecutor, TrainerExecutor,
                              WeightsCommunicationChannel)
from repro_torch.models import init_params
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

TIMEOUT = 60.0


def micro_cfg(cfg):
    return cfg.replace(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                       head_dim=16, d_ff=64, vocab=64)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in
                flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree) for k2, v in
                flat(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def assert_bit_equal(got, want):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k].view(torch.uint8) if g[k].numel() else g[k],
                           w[k].view(torch.uint8) if w[k].numel()
                           else w[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_is_bit_exact(dtype, tmp_path):
    params = init_params(micro_cfg(smoke()), seed=3, dtype=dtype,
                         device="cpu")
    tree = {"params": params, "extra": [torch.arange(5),
                                        (torch.randn(2, 3).to(dtype),)]}
    save_checkpoint(str(tmp_path / "ck"), tree)
    like = {"extra": [torch.zeros(5, dtype=torch.int64),
                      (torch.zeros(2, 3, dtype=dtype),)],
            "params": init_params(micro_cfg(smoke()), seed=0, dtype=dtype,
                                  device="cpu")}
    got = restore_checkpoint(str(tmp_path / "ck"), like)
    assert list(got) == ["extra", "params"]     # the caller's key order
    assert_bit_equal({"params": got["params"], "extra": got["extra"]}, tree)
    manifest = json.loads((tmp_path / "ck.json").read_text())
    assert manifest["n_leaves"] == len(flat(tree))
    assert set(manifest["dtypes"]) == {str(dtype).split(".")[1], "int64"}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_checkpoint_restores_in_the_port(dtype, tmp_path):
    """A file the JAX package wrote -- bf16 leaves included, which its
    own ``restore_checkpoint`` cannot read back -- restores here equal to
    ``convert.from_jax_numpy`` of the same params, with the same
    manifest the port writes."""
    jcfg = micro_cfg(jsmoke())
    jparams = jax.device_get(
        jinit_params(jcfg, jax.random.PRNGKey(7), dtype))
    jsave(str(tmp_path / "jax"), jparams)
    want = convert.from_jax_numpy(jparams, device="cpu")
    like = init_params(micro_cfg(smoke()), seed=0,
                       dtype=want["embed"].dtype, device="cpu")
    assert_bit_equal(restore_checkpoint(str(tmp_path / "jax"), like), want)
    save_checkpoint(str(tmp_path / "port"), want)
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    params = init_params(micro_cfg(smoke()), seed=5, dtype=torch.float32,
                         device="cpu")
    save_checkpoint(str(tmp_path / "port"), params)
    like = jinit_params(micro_cfg(jsmoke()), jax.random.PRNGKey(0),
                        jnp.float32)
    got = jax.device_get(jrestore(str(tmp_path / "port"), like))
    want = convert.to_jax_numpy(params)
    fg, fw = flat(got), flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype
        assert np.array_equal(fg[k], fw[k]), k


def test_checkpoint_every_writes_the_reference_steps(tmp_path):
    """Six steps with ``checkpoint_every=2``: ``trainer_1``, ``_3`` and
    ``_5`` in both packages, threaded and sequential, and the last file
    restores to the trainer's final params bit for bit."""
    def port(path, sequential):
        cfg = micro_cfg(smoke())
        gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=8, seed=1),
                                n_prompts=2, n_per_prompt=2, max_new=3,
                                seed=1, device="cpu")
        rew = RewardExecutor(n_per_prompt=2)
        trn = TrainerExecutor(cfg, lr=5e-2, seed=1, device="cpu")
        ctl = ExecutorController(
            [gen, rew, trn],
            [WeightsCommunicationChannel("policy_model", trn, gen),
             CommunicationChannel("completions", gen, rew, CommType.GATHER),
             CommunicationChannel("completions_with_reward", rew, trn,
                                  CommType.SCATTER)],
            max_steps=6, mode="async", staleness=1, timeout=TIMEOUT,
            checkpoint_every=2, checkpoint_path=str(path))
        ctl.run_sequential() if sequential else ctl.run()
        return trn

    jcfg = micro_cfg(jsmoke())
    jgen = JGenerator(jcfg, JTasks(prompt_len=8, seed=1), n_prompts=2,
                      n_per_prompt=2, max_new=3, seed=1)
    jrew = JReward(n_per_prompt=2)
    jtrn = JTrainer(jcfg, lr=5e-2, seed=1)
    JController(
        [jgen, jrew, jtrn],
        [JWeights("policy_model", jtrn, jgen),
         JChannel("completions", jgen, jrew, JCommType.GATHER),
         JChannel("completions_with_reward", jrew, jtrn, JCommType.SCATTER)],
        max_steps=6, mode="async", staleness=1, timeout=TIMEOUT,
        checkpoint_every=2, checkpoint_path=str(tmp_path / "jax")).run()
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert want == [f"trainer_{n}.{ext}" for n in (1, 3, 5)
                    for ext in ("json", "npz")]
    for sequential in (False, True):
        path = tmp_path / f"port{int(sequential)}"
        trn = port(path, sequential)
        assert sorted(p.name for p in path.iterdir()) == want
        params = trn.get_model()
        assert_bit_equal(restore_checkpoint(str(path / "trainer_5"), params),
                         params)


def test_train_arithmetic_rl_runs_two_steps(tmp_path, capsys):
    """The train_arithmetic_rl twin: two stretches of one step, an eval line each, a
    checkpoint each, the last equal to the trainer's final params."""
    ck = tmp_path / "ck"
    out = train_arithmetic_rl.main(
        ["--device", "cpu", "--steps", "2", "--eval-every", "1",
         "--d-model", "32", "--layers", "1", "--checkpoint-path", str(ck)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2 and "greedy_acc=" in lines[0]
    assert [e["step"] for e in out["evals"]] == [1, 2]
    assert all(0.0 <= e["greedy_acc"] <= 1.0 for e in out["evals"])
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert sorted(p.name for p in ck.iterdir()) == [
        "trainer_0.json", "trainer_0.npz", "trainer_1.json",
        "trainer_1.npz"]
    assert_bit_equal(restore_checkpoint(str(ck / "trainer_1"), out["model"]),
                     out["model"])
