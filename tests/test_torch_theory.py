"""The port's section-7 performance model (``repro_torch.core.theory``)
against the JAX package's: the same inputs give the same outputs, and
Theorem 7.5 holds over random hardware and eta curves."""
import dataclasses

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.core import theory as jtheory
from repro_torch.core import theory


def _hw(mod, rng):
    return mod.HWConfig(G0=int(rng.integers(64, 2048)),
                        B0=int(rng.integers(256, 4096)), M0=80e9,
                        W0=float(rng.uniform(1e10, 1e12)),
                        A_t=float(rng.uniform(1e5, 1e7)),
                        K_g=float(rng.uniform(1e4, 1e6)))


def _eta(mod, rng):
    return mod.EtaCurve(alpha=float(rng.uniform(1e-4, 1e-2)),
                        beta=float(rng.uniform(1e-3, 1e-1)))


@pytest.mark.parametrize("seed", range(4))
def test_solvers_equal_reference(seed):
    """solve_sync, solve_async and speedup give the reference's dicts,
    value for value, on random hardware and eta curves (max_b 2^10)."""
    outs = []
    for mod in (theory, jtheory):
        rng = np.random.default_rng(seed)
        hw, et, eg = _hw(mod, rng), _eta(mod, rng), _eta(mod, rng)
        outs.append((mod.solve_sync(hw, et, eg, 1 << 10),
                     mod.solve_async(hw, et, eg, 1 << 10),
                     mod.speedup(hw, et, eg, 1 << 10)))
    assert outs[0] == outs[1]


def test_memory_and_step_time_models_equal_reference():
    """trainer_mem, generator_mem, t_sync, t_async, the eta curve (arrays
    and b = 0 included) and llama_hw's presets."""
    for params_b, gpus in ((8, 256), (70, 1024), (405, 4096)):
        hw, jhw = theory.llama_hw(params_b, gpus), jtheory.llama_hw(
            params_b, gpus)
        assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)
        et, jet = theory.EtaCurve(1e-3, 2e-2), jtheory.EtaCurve(1e-3, 2e-2)
        eg, jeg = theory.EtaCurve(3e-3, 5e-2), jtheory.EtaCurve(3e-3, 5e-2)
        b = np.array([0, 1, 7, 64, 4096])
        np.testing.assert_array_equal(et(b), jet(b))
        assert theory.trainer_mem(hw, 16, 8) == jtheory.trainer_mem(jhw, 16, 8)
        assert theory.generator_mem(hw, 64, 4) == \
            jtheory.generator_mem(jhw, 64, 4)
        assert theory.t_sync(hw, et, eg, 16, 64, 8) == \
            jtheory.t_sync(jhw, jet, jeg, 16, 64, 8)
        assert theory.t_async(hw, et, eg, 16, 64, 8, 4, 0.3) == \
            jtheory.t_async(jhw, jet, jeg, 16, 64, 8, 4, 0.3)


def test_fit_eta_equals_reference():
    """fit_eta recovers alpha + beta / b from exact samples, as the
    reference does, and clamps a negative coefficient to 0."""
    b = [1, 2, 4, 8, 16, 32]
    y = [0.002 + 0.05 / x for x in b]
    got, want = theory.fit_eta(b, y), jtheory.fit_eta(b, y)
    assert (got.alpha, got.beta) == (want.alpha, want.beta)
    assert abs(got.alpha - 0.002) < 1e-12 and abs(got.beta - 0.05) < 1e-12
    y = [0.05 - 0.01 / x for x in b]
    got, want = theory.fit_eta(b, y), jtheory.fit_eta(b, y)
    assert (got.alpha, got.beta) == (want.alpha, want.beta)
    assert got.beta == 0.0


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_theory_thm75_holds_over_random_hw(seed):
    """Property (the twin of test_rl_system.py's): Theorem 7.5 (async
    strictly faster) holds for any hw config and monotone eta curves."""
    rng = np.random.default_rng(seed)
    hw, et, eg = _hw(theory, rng), _eta(theory, rng), _eta(theory, rng)
    r = theory.speedup(hw, et, eg, max_b=1 << 12)
    assert r["theorem_7_5_holds"], r
