"""The port's native runtime (``smart_nanogrid_gym_torch/native``) and its
seed replay (``core/generate.py::schedule_from_reference_seed``) against the
JAX package's.

- ``generate_schedule_native`` bit-equal (``np.array_equal``) to the JAX
  package's over seeds × (different capacities, requested SoC), and at 2 h;
- ``schedule_from_reference_seed`` (and the batched
  ``schedules_from_reference_seeds``) bit-equal to JAX's tables;
- a day replayed from a bare seed: the port's plain f64 engine against the
  JAX engine on the same schedule, at 1e-12;
- ``NativeEngine`` against the port's plain engine at 1e-9 in f64, and
  ``NativeBatchEngine`` equal to individual engines;
- the library is built under ``build/torch_native/`` from the port's own
  copy of the source, with ``-ffp-contract=off``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig as JaxConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.core.generate import schedule_from_reference_seed as jax_schedule_from_seed
from smart_nanogrid_gym_tpu.core.transition import reset as jax_reset, step as jax_step
from smart_nanogrid_gym_tpu.native import generate_schedule_native as jax_generate

from smart_nanogrid_gym_torch import native
from smart_nanogrid_gym_torch.core import (
    NanogridConfig, make_params, reset, schedule_from_reference_seed, schedules_from_reference_seeds, step)
from smart_nanogrid_gym_torch.core.state import DaySchedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"basic": dict(pv_system=False, battery_system=False),
            "b-pv": dict(pv_system=True, battery_system=True)}


@pytest.mark.parametrize("seed", [0, 1, 42, 123456])
@pytest.mark.parametrize("diff_caps,req_soc", [(True, False), (False, False), (True, True)])
def test_generation_bit_equal_to_the_jax_package(seed, diff_caps, req_soc):
    got = native.generate_schedule_native(seed, 6, 1.0, different_capacities=diff_caps, requested_soc=req_soc)
    want = jax_generate(seed, 6, 1.0, different_capacities=diff_caps, requested_soc=req_soc)
    assert set(got) == set(want) == set(native.SCHEDULE_FIELDS)
    for name in native.SCHEDULE_FIELDS:
        assert np.array_equal(got[name], want[name]), name


def test_generation_bit_equal_at_2h():
    got = native.generate_schedule_native(3, 4, 2.0, table_len=25)
    want = jax_generate(3, 4, 2.0, table_len=25)
    for name in native.SCHEDULE_FIELDS:
        assert np.array_equal(got[name], want[name]), name
    assert got["occupancy"][:, 12:].sum() == 0


@pytest.mark.parametrize("kw", [{}, {"num_chargers": 4, "time_interval": 0.5},
                                {"different_battery_capacities": False, "requested_state_of_charge": True}])
def test_schedule_from_reference_seed_bit_equal_to_jax(kw):
    config, jconfig = NanogridConfig(**kw), JaxConfig(**kw)
    got = schedule_from_reference_seed(17, config, device="cpu")
    want = jax_schedule_from_seed(17, jconfig)
    batch = schedules_from_reference_seeds([5, 17], config, torch.float32, "cpu")
    for name in DaySchedule._fields:
        x = getattr(got, name)
        assert x.dtype == torch.float64 and x.shape == (config.num_chargers, config.table_len)
        assert np.array_equal(x.numpy(), np.asarray(getattr(want, name))), name
        assert torch.equal(getattr(batch, name)[1], x.float()), name
    assert not torch.equal(batch.occupancy[0], batch.occupancy[1])


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("variant", ["basic", "b-pv"])
def test_seed_replay_day_matches_the_jax_engine(seed, variant):
    """The day of a bare seed through the port's plain f64 engine and the JAX
    engine on the same schedule: observations and rewards at 1e-12."""
    kw = dict(num_chargers=4, **VARIANTS[variant])
    config, jconfig = NanogridConfig(**kw), JaxConfig(**kw)
    params = make_params(config, torch.float64, "cpu")
    day = schedule_from_reference_seed(seed, config, device="cpu")
    state, obs0 = reset(config, params, DaySchedule(*(x[None] for x in day)),
                        pv_shift=torch.ones(1, dtype=torch.float64))
    with jax.enable_x64(True):
        jparams = jax_make_params(jconfig, dtype=jnp.float64)
        jstate, jobs0 = jax_reset(jconfig, jparams, jax.random.PRNGKey(0), schedule=jax_schedule_from_seed(seed, jconfig))
        jstate = jstate._replace(pv_shift=jnp.asarray(1.0, jnp.float64))
        np.testing.assert_allclose(obs0[0].numpy(), np.asarray(jobs0), rtol=1e-12, atol=1e-12)
        rng = np.random.RandomState(seed + 1)
        for t in range(config.steps_per_day):
            a = rng.uniform(0, 1, config.num_actions)
            res = step(config, params, state, torch.from_numpy(a)[None], next_pv_shift=torch.ones(1, dtype=torch.float64))
            jres = jax_step(jconfig, jparams, jstate, jnp.asarray(a))
            state, jstate = res.state, jres.state
            np.testing.assert_allclose(res.obs[0].numpy(), np.asarray(jres.obs), rtol=1e-12, atol=1e-12,
                                       err_msg=f"obs at step {t}")
            np.testing.assert_allclose(float(res.reward[0]), float(jres.reward), rtol=1e-12, atol=1e-12,
                                       err_msg=f"reward at step {t}")
            assert bool(res.done[0]) == bool(jres.done)


def test_native_engine_matches_the_plain_engine():
    """``NativeEngine`` on a native day against the port's plain engine in
    f64 (the counterpart of tests/test_native.py::test_native_engine_vs_jax_engine)."""
    config = NanogridConfig(num_chargers=8, pv_system=True, battery_system=True)
    params = make_params(config, torch.float64, "cpu")
    tables = native.generate_schedule_native(777, 8, 1.0)
    day = DaySchedule(*(torch.from_numpy(tables[name])[None] for name in DaySchedule._fields))
    f64 = dict(dtype=torch.float64)
    state, obs0 = reset(config, params, day, batt_soc=torch.full((1,), 0.5, **f64),
                        pv_shift=torch.full((1,), 0.9, **f64))
    eng = native.NativeEngine(config)
    assert eng.obs_dim == config.obs_dim
    np.testing.assert_allclose(eng.reset(tables, batt_soc=0.5, pv_shift=0.9), obs0[0].numpy(), rtol=1e-6, atol=1e-7)
    rng = np.random.RandomState(3)
    for i in range(24):
        a = np.concatenate([rng.uniform(0, 1, 8), rng.uniform(-1, 1, 1)])
        res = step(config, params, state, torch.from_numpy(a)[None], next_pv_shift=torch.full((1,), 0.9, **f64))
        state = res.state
        obs, reward, done, info = eng.step(a)
        np.testing.assert_allclose(reward, float(res.reward[0]), rtol=1e-9, atol=1e-9, err_msg=f"reward at {i}")
        np.testing.assert_allclose(obs, res.obs[0].numpy(), rtol=1e-6, atol=1e-7, err_msg=f"obs at {i}")
        np.testing.assert_allclose(info["charger_power_values"], res.info.charger_power_values[0].numpy(),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(info["total_cost"], float(res.info.total_cost[0]), rtol=1e-9, atol=1e-9)
        assert done == bool(res.done[0])
    # the engine also takes the port's params and a one-env DaySchedule
    eng2 = native.NativeEngine(config, params)
    assert np.array_equal(eng2.reset(day, batt_soc=0.5, pv_shift=0.9), eng.reset(tables, batt_soc=0.5, pv_shift=0.9))


def test_native_batch_engine_equals_individual_engines():
    config = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
    B = 8
    schedules = [native.generate_schedule_native(1000 + i, 4, 1.0) for i in range(B)]
    shifts = np.linspace(0.2, 1.6, B)
    batch = native.NativeBatchEngine(config, B)
    singles = [native.NativeEngine(config) for _ in range(B)]
    obs_b = batch.reset(schedules, batt_soc=0.5, pv_shifts=shifts)
    obs_s = np.stack([e.reset(schedules[i], batt_soc=0.5, pv_shift=shifts[i]) for i, e in enumerate(singles)])
    assert np.array_equal(obs_b, obs_s)
    rng = np.random.RandomState(9)
    for t in range(24):
        actions = rng.uniform(-1, 1, (B, 5))
        actions[:, :4] = np.abs(actions[:, :4])
        ob, rew, done, infos = batch.step_batch(actions)
        for i in range(B):
            o, r, d, info = singles[i].step(actions[i])
            assert np.array_equal(ob[i], o) and rew[i] == r and done[i] == d, (i, t)
            assert np.array_equal(infos["charger_power_values"][i], info["charger_power_values"])
            assert infos["total_cost"][i] == info["total_cost"]
    assert done.all()
    with pytest.raises(ValueError, match="actions must be"):
        batch.step_batch(np.zeros((B, 4)))


def test_library_built_from_the_ports_source(monkeypatch):
    path, _ = native.build()
    assert path.parent == native.BUILD_DIR and native.BUILD_DIR == native.Path(REPO, "build", "torch_native")
    assert path.exists() and native.SOURCE.parent == native.NATIVE_DIR
    assert native.NATIVE_DIR == native.Path(REPO, "smart_nanogrid_gym_torch", "native")
    assert "-ffp-contract=off" in native.compiler_flags()
    assert not list(native.NATIVE_DIR.glob("*.so"))  # no prebuilt library ships with the port
    # a missing compiler fails loudly instead of carrying on
    monkeypatch.setattr(native, "library_path", lambda: native.BUILD_DIR / "absent.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs make"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None if name == "g++" else "/usr/bin/make")
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.build()
