"""The port's stateful-env entry point against the JAX package: the gym
adapter, the vector env, ``predict_single_day`` and the JSON schedule
helpers.

Both adapters replay the same ``initial_values.json`` in float64 with the PV
shift pinned equal on both sides (PV days are not in the JSON), under the
same ``RandomState(31)`` actions: observations, rewards and every dumped
series agree at 1e-12, with the same file names and keys.  The vector env's
day equals the plain engine's fused day, and ``predict_single_day`` equals
the JAX function on every telemetry field.
"""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.compat.gym_adapter import SmartNanogridEnv as JaxEnv
from smart_nanogrid_gym_tpu.core import NanogridConfig as JaxConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.core import SmartNanogridTPU
from smart_nanogrid_gym_tpu.core import generate as jax_generate
from smart_nanogrid_gym_tpu.core.transition import observe as jax_observe
from smart_nanogrid_gym_tpu.solvers.evaluator import predict_single_day as jax_predict_single_day
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn as jax_rbc_policy_fn

from smart_nanogrid_gym_torch.compat import SmartNanogridEnv, VectorSmartNanogridEnv
from smart_nanogrid_gym_torch.compat import gym_adapter
from smart_nanogrid_gym_torch.core import NanogridConfig, SmartNanogridTorch, fused_day_rollout, make_params
from smart_nanogrid_gym_torch.core import generate
from smart_nanogrid_gym_torch.solvers import make_rbc_policy_fn, predict_single_day

VARIANTS = {
    "basic": dict(pv_system_available_in_model=False, battery_system_available_in_model=False),
    "b-pv": dict(pv_system_available_in_model=True, battery_system_available_in_model=True),
    "v2x-b-pv": dict(pv_system_available_in_model=True, battery_system_available_in_model=True,
                     vehicle_to_everything=True),
}


def reference_kwargs(variant, **extra):
    return dict(price_model=0, number_of_chargers=4, time_interval="1h", charging_mode="bounded",
                vehicle_uncharged_penalty_mode="sparse", algorithm_used="PPO", environment_mode="evaluation",
                **VARIANTS[variant], **extra)


def random_actions(config, steps=24):
    """``RandomState(31)`` actions: chargers in their box, the battery in [-1, 1]."""
    rng = np.random.RandomState(31)
    low = -1.0 if config.vehicle_to_everything else 0.0
    out = []
    for _ in range(steps):
        a = rng.uniform(low, 1, config.num_chargers)
        out.append(np.append(a, rng.uniform(-1, 1)) if config.battery_system else a)
    return out


def json_files(root):
    found = {}
    for base, _, files in os.walk(root):
        for name in files:
            with open(os.path.join(base, name)) as fp:
                found[os.path.relpath(os.path.join(base, name), root)] = json.load(fp)
    return found


def assert_json_close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if key in ("Arrivals", "Departures"):  # per-charger lists of steps, ragged
            assert got[key] == want[key], key
        else:
            np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(want[key], float), rtol=0,
                                       atol=1e-12, err_msg=key)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_adapter_replays_json_like_the_jax_adapter(variant, tmp_path):
    kw = reference_kwargs(variant)
    jax_env = JaxEnv(**kw, output_directory=str(tmp_path / "jax"), dtype=jnp.float64, seed=44)
    jax_env.reset()  # generates a day and writes initial_values.json
    day = str(tmp_path / "jax" / "initial_values.json")
    port_env = SmartNanogridEnv(**kw, output_directory=str(tmp_path / "port"), dtype=torch.float64, device="cpu")

    jax_env.reset(generate_new_initial_values=False, initial_values_path=day)
    port_env.reset(generate_new_initial_values=False, initial_values_path=day)
    os.remove(day)  # compare only what the replayed day writes
    jax_env._state = jax_env._state._replace(pv_shift=jnp.asarray(1.3, jnp.float64))
    port_env._state = port_env._state._replace(pv_shift=torch.tensor(1.3, dtype=torch.float64))
    np.testing.assert_allclose(port_env.engine.observe(port_env.params, port_env._state).numpy(),
                               np.asarray(jax_observe(jax_env.config, jax_env.params, jax_env._state)),
                               rtol=0, atol=1e-12)

    for i, a in enumerate(random_actions(port_env.config)):
        obs_j, rew_j, done_j, trunc_j, _ = jax_env.step(a)
        obs_p, rew_p, done_p, trunc_p, info = port_env.step(a)
        assert obs_p.dtype == obs_j.dtype and info == {}
        np.testing.assert_allclose(obs_p, obs_j, rtol=0, atol=1e-12, err_msg=f"obs at step {i}")
        np.testing.assert_allclose(rew_p, rew_j, rtol=0, atol=1e-12, err_msg=f"reward at step {i}")
        assert (done_p, trunc_p) == (done_j, trunc_j) == (i == 23, False)

    got, want = json_files(tmp_path / "port"), json_files(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(want) == 3
    for name in want:
        assert_json_close(got[name], want[name])
    results = got[os.path.join("RL", "evaluation_files", "prediction_results.json")]
    assert len(results) == 28


def test_adapter_carries_the_battery_across_resets(tmp_path):
    env = SmartNanogridEnv(**reference_kwargs("b-pv"), output_directory=str(tmp_path), device="cpu", seed=2)
    obs, _ = env.reset()
    assert obs[-1] == np.float32(0.5)
    for battery_action in (-0.5, 0.3):
        for _ in range(24):
            obs, _, done, _, _ = env.step(np.append(np.full(4, 0.2), battery_action))
        final = float(env._state.batt_soc)
        assert done and final != 0.5
        obs, _ = env.reset()
        assert float(env._state.batt_soc) == final == env._initial_battery
        assert obs[-1] == np.float32(final)


def test_adapter_raises_on_what_the_reference_refuses(tmp_path):
    with pytest.raises(ValueError):
        SmartNanogridEnv(time_interval="7q", device="cpu")
    with pytest.raises(ValueError):
        SmartNanogridEnv(price_model=5, device="cpu")
    with pytest.raises(ValueError):
        SmartNanogridEnv(charging_mode="bogus", device="cpu")
    env = SmartNanogridEnv(**reference_kwargs("b-pv"), output_directory=str(tmp_path), device="cpu")
    env.reset()
    with pytest.raises(ValueError, match="expected 5 actions"):
        env.step(np.zeros(6))


def test_adapter_runs_without_gymnasium(monkeypatch, tmp_path):
    """With gymnasium hidden the adapter is a plain duck-typed env: spaces
    None, the same 5-tuple step and dumps."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    plain = importlib.reload(gym_adapter)
    try:
        assert plain.gymnasium is None and plain.SmartNanogridEnv.__bases__ == (object,)
        env = plain.SmartNanogridEnv(**reference_kwargs("b-pv"), output_directory=str(tmp_path), device="cpu")
        assert env.observation_space is None and env.action_space is None
        obs, info = env.reset(seed=3)
        assert obs.shape == (17,) and info == {}
        for _ in range(24):
            obs, reward, done, truncated, _ = env.step(np.full(5, 0.1))
        assert done and not truncated and np.isfinite(reward)
        assert len(json_files(tmp_path)) == 4  # initial values, and the three day-end dumps
    finally:
        monkeypatch.undo()
        importlib.reload(gym_adapter)


def test_gymnasium_registers_both_packages():
    gymnasium = pytest.importorskip("gymnasium")
    import smart_nanogrid_gym_tpu.envs  # noqa: F401  (registers SmartNanogridEnv-v0)
    import smart_nanogrid_gym_torch.envs as torch_envs

    spec = gymnasium.spec(torch_envs.ENV_ID)
    assert spec.entry_point == "smart_nanogrid_gym_torch.envs:SmartNanogridEnv" and spec.max_episode_steps == 200
    assert gymnasium.spec("SmartNanogridEnv-v0").entry_point == "smart_nanogrid_gym_tpu.envs:SmartNanogridEnv"
    kw = dict(number_of_chargers=4, pv_system_available_in_model=False, battery_system_available_in_model=False,
              time_interval="1h", vehicle_uncharged_penalty_mode="dense", output_directory=None)
    for env in (gymnasium.make(torch_envs.ENV_ID, device="cpu", **kw), gymnasium.make("SmartNanogridEnv-v0", **kw)):
        obs, _ = env.reset(seed=1)
        assert obs.shape == (12,)
        obs, reward, done, trunc, info = env.step(np.zeros(4, dtype=np.float32))
        assert np.isfinite(reward) and not done


def test_gymnasium_check_env():
    pytest.importorskip("gymnasium")
    from gymnasium.utils.env_checker import check_env

    env = SmartNanogridEnv(number_of_chargers=4, pv_system_available_in_model=False,
                           battery_system_available_in_model=False, time_interval="1h",
                           vehicle_uncharged_penalty_mode="dense", device="cpu")
    check_env(env, skip_render_check=True)


def test_vector_env_day_equals_fused_rollout_then_autoresets():
    venv = VectorSmartNanogridEnv(num_envs=64, seed=4, dtype=torch.float64, device="cpu",
                                  **reference_kwargs("b-pv"))
    config, params = venv.config, venv.params
    obs, _ = venv.reset()
    day1 = venv.states
    rbc = make_rbc_policy_fn(config)
    _, (_, rewards, _) = fused_day_rollout(config, params, day1, rbc, next_pv_shift=day1.pv_shift)
    for t in range(24):
        obs, rew, term, trunc, infos = venv.step(rbc(torch.from_numpy(obs)).numpy())
        np.testing.assert_allclose(rew, rewards[t].numpy(), rtol=0, atol=1e-12)
        assert term.all() == (t == 23) and not trunc.any()
    # day end: fresh days, the battery carried into them
    assert "final_observation" in infos and bool((venv.states.t == 0).all())
    assert not torch.equal(venv.states.schedule.occupancy, day1.schedule.occupancy)
    np.testing.assert_array_equal(obs[:, -1], infos["final_observation"][:, -1])
    for t in range(24):
        obs, rew, term, _, infos = venv.step(np.tile(np.append(np.full(4, 0.3), -0.4), (64, 1)))
    assert term.all() and (obs[:, -1] < 0.5).all()
    np.testing.assert_array_equal(obs[:, -1], infos["final_observation"][:, -1])
    obs, _, term, _, _ = venv.step(np.zeros((64, 5)))
    assert not term.any()


def test_json_helpers_match_jax(tmp_path):
    """``schedule_from_arrays`` / ``load_initial_values_json`` /
    ``schedule_to_json_dict`` against the JAX helpers, with and without the
    optional ``Requested_SOC``."""
    for kw in ({}, {"requested_state_of_charge": True}):
        jax_cfg, cfg = JaxConfig(num_chargers=4, **kw), NanogridConfig(num_chargers=4, **kw)
        jax_sched = jax_generate.generate_schedule(jax.random.PRNGKey(3), jax_cfg,
                                                   jax_make_params(jax_cfg, dtype=jnp.float64))
        payload = jax_generate.schedule_to_json_dict(jax_sched, jax_cfg)
        for drop in (False, True):
            day = dict(payload)
            if drop:
                day.pop("Requested_SOC")
            path = tmp_path / "day.json"
            path.write_text(json.dumps(day))
            want = jax_generate.load_initial_values_json(str(path), jax_cfg)
            for dtype in (torch.float64, torch.float32):
                got = generate.load_initial_values_json(str(path), cfg, dtype, "cpu")
                for name, g, w in zip(want._fields, got, want):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype), err_msg=name)
            assert generate.schedule_to_json_dict(got, cfg) == jax_generate.schedule_to_json_dict(
                jax_generate.load_initial_values_json(str(path), jax_cfg, np.float32), jax_cfg)


def test_predict_single_day_matches_jax(tmp_path):
    """Rewards and all 26 telemetry fields at 1e-12 in f64, on a JSON day with
    the PV shift pinned, for the RBC and an affine policy that drives the
    battery both ways."""
    kw = dict(num_chargers=4, pv_system=True, battery_system=True, vehicle_to_everything=True)
    jax_cfg, cfg = JaxConfig(**kw), NanogridConfig(**kw)
    jax_params, params = jax_make_params(jax_cfg, dtype=jnp.float64), make_params(cfg, torch.float64, "cpu")
    jax_env = JaxEnv(number_of_chargers=4, vehicle_to_everything=True, time_interval="1h",
                     output_directory=str(tmp_path), dtype=jnp.float64, seed=9)
    jax_env.reset()
    day = str(tmp_path / "initial_values.json")
    jax_sched = jax_generate.load_initial_values_json(day, jax_cfg)
    sched = generate.load_initial_values_json(day, cfg, torch.float64, "cpu")

    rng = np.random.default_rng(0)
    w = 0.3 * rng.standard_normal((cfg.num_actions, cfg.obs_dim))
    b = 0.2 * rng.standard_normal(cfg.num_actions)
    low, high = cfg.action_bounds()
    jax_rbc = jax_rbc_policy_fn(jax_cfg)
    policies = {
        "rbc": (lambda ob, k: jax_rbc(ob), make_rbc_policy_fn(cfg)),
        "affine": (lambda ob, k: jnp.clip(jnp.asarray(w) @ ob + b, low, high),
                   lambda ob: torch.clamp(torch.from_numpy(w) @ ob.double() + torch.from_numpy(b),
                                          torch.from_numpy(low).double(), torch.from_numpy(high).double())),
    }
    for name, (jax_policy, policy) in policies.items():
        rew_j, info_j = jax_predict_single_day(jax_cfg, jax_params, jax_policy, seed=0, schedule=jax_sched,
                                               pv_shift=1.2)
        rew, info = predict_single_day(cfg, params, policy, torch.Generator().manual_seed(0), schedule=sched,
                                       pv_shift=1.2)
        np.testing.assert_allclose(rew, rew_j, rtol=0, atol=1e-12, err_msg=name)
        assert len(info) == 26 and info._fields == info_j._fields
        for field, got, want in zip(info._fields, info, info_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12, err_msg=f"{name} {field}")
    assert (info.battery_action.numpy() > 0).any() and (info.battery_action.numpy() < 0).any()


def test_single_env_engine_matches_jax(tmp_path):
    """``SmartNanogridTorch``'s single-env ``reset`` (a replayed JSON day),
    ``rollout_actions(batched=False)`` and ``rollout_day(batched=False)``
    against ``SmartNanogridTPU``'s, f64, the PV shift pinned on both sides."""
    kw = dict(num_chargers=4, pv_system=True, battery_system=True, vehicle_to_everything=True)
    jax_cfg, cfg = JaxConfig(**kw), NanogridConfig(**kw)
    jax_engine, engine = SmartNanogridTPU(jax_cfg), SmartNanogridTorch(cfg)
    jax_params, params = jax_engine.default_params(jnp.float64), engine.default_params(torch.float64, "cpu")
    JaxEnv(number_of_chargers=4, vehicle_to_everything=True, time_interval="1h", output_directory=str(tmp_path),
           seed=5).reset()
    day = str(tmp_path / "initial_values.json")
    jax_state, _ = jax_engine.reset(jax_params, jax.random.PRNGKey(0),
                                    schedule=jax_generate.load_initial_values_json(day, jax_cfg))
    jax_state = jax_state._replace(pv_shift=jnp.asarray(1.1, jnp.float64))
    state, _ = engine.reset(params, torch.Generator().manual_seed(0),
                            schedule=generate.load_initial_values_json(day, cfg, torch.float64, "cpu"), pv_shift=1.1)
    np.testing.assert_array_equal(engine.observe(params, state).numpy(),
                                  np.asarray(jax_engine.observe(jax_params, jax_state)))

    actions = np.random.default_rng(1).uniform(-1, 1, (cfg.steps_per_day, cfg.num_actions))
    jax_final, jax_traj = jax_engine.rollout_actions(jax_params, jax_state, jnp.asarray(actions), batched=False)
    final, traj = engine.rollout_actions(params, state, torch.from_numpy(actions), torch.Generator(), batched=False)
    for got, want in zip(traj[:3] + tuple(traj[3]), jax_traj[:3] + tuple(jax_traj[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    assert float(final.batt_soc) == pytest.approx(float(jax_final.batt_soc), abs=1e-12) and int(final.day) == 1

    obs0 = engine.observe(params, state)
    jax_rbc = jax_rbc_policy_fn(jax_cfg)
    _, _, (_, jax_rewards, _, _) = jax_engine.rollout_day(jax_params, jax_state, lambda ob, k: jax_rbc(ob),
                                                          jnp.asarray(obs0.numpy()), batched=False)
    _, final_obs, (_, rewards, dones, info) = engine.rollout_day(params, state, make_rbc_policy_fn(cfg), obs0,
                                                                 torch.Generator(), batched=False)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(jax_rewards), rtol=0, atol=1e-12)
    assert final_obs.shape == (cfg.obs_dim,) and bool(dones[-1]) and info.charger_actions.shape == (24, 4)
