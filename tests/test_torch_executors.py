"""Generator -> reference -> reward through the executors' ports, port
against the JAX package, wired as the controller wires them."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.llama_paper import smoke
from repro.core import executor as jex
from repro.models import init_params as jinit
from repro.rl.data import ArithmeticTasks as JTasks
from repro_torch import convert
from repro_torch.configs.llama_paper import smoke as tsmoke
from repro_torch.core import executor as tex
from repro_torch.rl.data import ArithmeticTasks


def _pipeline(mod, cfg, params, tasks, **kw):
    gen = mod.GeneratorExecutor(cfg, tasks, n_prompts=2, n_per_prompt=3,
                                max_new=10, chunk=4, seed=5, **kw)
    gen.set_weights(params, version=0)
    ref = mod.RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = mod.RewardExecutor(n_per_prompt=3, leave_one_out=True)
    outs = []
    for _ in range(2):
        ref.put_input("completions", gen.step())
        rew.put_input("completions_with_ref", ref.step())
        outs.append(rew.step())
    return outs


def test_executors_match_jax():
    jp = jinit(smoke(), jax.random.PRNGKey(0), jnp.float32)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    jouts = _pipeline(jex, smoke(), jp, JTasks(seed=0))
    touts = _pipeline(tex, tsmoke(), tp, ArithmeticTasks(seed=0),
                      device="cpu")
    for j, t in zip(jouts, touts):
        for name in ("tokens", "mask", "advantages"):
            assert np.array_equal(t[name].numpy(), np.asarray(j[name])), name
        for name in ("behavior_logp", "ref_logp"):
            err = np.max(np.abs(t[name].numpy() - np.asarray(j[name])))
            assert err < 1e-5, (name, err)
        assert t["mean_reward"] == j["mean_reward"]
        # at T = 1 both are log pi under the same weights
        m = t["mask"]
        assert ((t["behavior_logp"] - t["ref_logp"]) * m).abs().max() < 1e-4


def test_quantized_generator_matches_jax():
    """``quantize=True`` fake-quantizes the weights through int8 once at
    weight sync (``ddma.quantize_dequant``), as the reference does, with no
    int8 kernel, and then generates as the JAX generator does."""
    jp = jinit(smoke(), jax.random.PRNGKey(1), jnp.float32)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    jouts = _pipeline(jex, smoke(), jp, JTasks(seed=2), quantize=True)
    touts = _pipeline(tex, tsmoke(), tp, ArithmeticTasks(seed=2),
                      quantize=True, device="cpu")
    for j, t in zip(jouts, touts):
        assert np.array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
        err = np.max(np.abs(t["behavior_logp"].numpy()
                            - np.asarray(j["behavior_logp"])))
        assert err < 1e-5
