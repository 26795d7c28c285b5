"""The PyTorch port's plain engine against the JAX package, in float64.

Same numpy inputs go to both packages: uniform blocks, actions, initial
states built by JAX and converted.  ``generate_schedule`` must agree bit for
bit; physics, transition chains and the fused day rollout at 1e-12, the
tolerance tests/test_rollout_fused.py uses for engine against engine.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.core import physics as jax_physics
from smart_nanogrid_gym_tpu.core.generate import generate_schedule as jax_generate
from smart_nanogrid_gym_tpu.core.rollout import fused_day_rollout as jax_fused
from smart_nanogrid_gym_tpu.core.transition import reset as jax_reset, step as jax_step
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn as jax_rbc_fn

from smart_nanogrid_gym_torch.core import SmartNanogridTorch, physics
from smart_nanogrid_gym_torch.core.config import NanogridConfig as TorchConfig
from smart_nanogrid_gym_torch.core.generate import generate_schedule, generate_schedule_plain
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.core.rollout import fused_day_rollout
from smart_nanogrid_gym_torch.core.transition import step, step_plain
from smart_nanogrid_gym_torch.ops import launch_counts, reset_launch_counts
from smart_nanogrid_gym_torch.ops.engine_step import engine_step
from smart_nanogrid_gym_torch.ops.generate import generate_day
from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_flax, make_actor_policy_fn
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

from torch_parity import assert_same_step, params_to_torch, state_to_torch, to_numpy, to_torch

F64 = torch.float64
TOL = dict(rtol=1e-12, atol=1e-12)


def _bparams(config, batch):
    params = jax_make_params(config, dtype=jnp.float64)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), params)


def _jax_states(config, batch, seed):
    bparams = _bparams(config, batch)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    states, obs = jax.vmap(functools.partial(jax_reset, config))(bparams, keys, None, None)
    return bparams, states, obs


@pytest.mark.parametrize("config", [
    NanogridConfig(num_chargers=8),
    NanogridConfig(num_chargers=5, different_battery_capacities=False,
                   requested_state_of_charge=True),
    NanogridConfig(num_chargers=4, pv_system=False, battery_system=False, time_interval=2.0),
], ids=["b-pv-1h", "reqsoc-fixedcap", "basic-2h"])
def test_generate_schedule_bitwise(config):
    B = 32
    u = np.random.default_rng(0).random((B, config.steps_per_day, 5, config.num_chargers))
    params = jax_make_params(config, dtype=jnp.float64)
    ref = jax.vmap(lambda uu: jax_generate(None, config, params, uniforms=uu))(jnp.asarray(u))
    got = generate_schedule(config, make_params(config, F64, "cpu"), torch.from_numpy(u))
    for name, r, g in zip(ref._fields, ref, got):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(r), err_msg=name)


GEN_CONFIGS = [
    NanogridConfig(num_chargers=8),
    NanogridConfig(num_chargers=5, different_battery_capacities=False, requested_state_of_charge=True),
    NanogridConfig(num_chargers=4, pv_system=False, battery_system=False, time_interval=2.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("config", GEN_CONFIGS, ids=["b-pv-1h", "reqsoc-fixedcap", "basic-2h"])
def test_generate_schedule_on_the_cpu_is_the_plain_twin(config, dtype):
    """On CPU params ``generate_schedule`` returns ``generate_schedule_plain``'s
    tables exactly, from given uniforms and from a generator, and launches
    nothing."""
    params = make_params(config, dtype, "cpu")
    u = torch.rand((16, config.steps_per_day, 5, config.num_chargers), dtype=dtype,
                   generator=torch.Generator().manual_seed(2))
    reset_launch_counts()
    pairs = [(generate_schedule(config, params, u), generate_schedule_plain(config, params, u)),
             (generate_schedule(config, params, generator=torch.Generator().manual_seed(3), batch=16),
              generate_schedule_plain(config, params, generator=torch.Generator().manual_seed(3), batch=16))]
    assert sum(launch_counts.values()) == 0
    for got, want in pairs:
        for name, g, w in zip(want._fields, got, want):
            assert g.dtype == dtype and torch.equal(g, w), name


@pytest.mark.parametrize("case", ["shape", "device"])
def test_generate_day_checks_before_it_launches(case):
    """The kernel's wrapper refuses a uniform block of the wrong shape and
    params off the card, before it loads a library or launches."""
    config = GEN_CONFIGS[0]
    params = make_params(config, torch.float32, "cpu")
    u = torch.rand((4, config.steps_per_day, 5, config.num_chargers), generator=torch.Generator().manual_seed(0))
    reset_launch_counts()
    if case == "shape":
        with pytest.raises(ValueError, match="uniforms must be"):
            generate_day(config, params, u[..., :-1])
        with pytest.raises(ValueError, match="uniforms must be"):
            generate_schedule(config, params, u[..., :-1])
    else:
        with pytest.raises(ValueError, match="CUDA device"):
            generate_day(config, params, u)
    assert sum(launch_counts.values()) == 0


STEP_CONFIGS = {
    "b-pv-sparse": TorchConfig(num_chargers=8),
    "reqsoc-fixedcap-dense": TorchConfig(num_chargers=5, different_battery_capacities=False,
                                         requested_state_of_charge=True, penalty_mode="dense"),
    "basic-2h-on_departure": TorchConfig(num_chargers=4, pv_system=False, battery_system=False, time_interval=2.0,
                                         penalty_mode="on_departure"),
    "pv-no_penalty-lookahead2-f64obs": TorchConfig(num_chargers=3, battery_system=False, penalty_mode="no_penalty",
                                                   lookahead=2, cast_obs_to_f32=False),
}


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_step_on_the_cpu_is_the_plain_twin(name, dtype):
    """On CPU params ``step`` returns ``step_plain``'s result exactly, leaf by
    leaf and alias by alias, through a day end, with the PV shift given and
    drawn (the generator left where the twin leaves it), and launches
    nothing."""
    config = STEP_CONFIGS[name]
    params = make_params(config, dtype, "cpu")
    g = torch.Generator().manual_seed(5)
    state, _ = SmartNanogridTorch(config).reset_batch(params, 16, g)
    reset_launch_counts()
    for k in range(config.steps_per_day + 1):
        action = 2.4 * torch.rand((16, config.num_actions), generator=g, dtype=dtype) - 1.2
        action[:, k % config.num_actions] = 0.0
        shift = torch.rand(16, generator=g, dtype=dtype)
        assert_same_step(step(config, params, state, action, next_pv_shift=shift),
                         step_plain(config, params, state, action, next_pv_shift=shift))
        twin_g = torch.Generator().set_state(g.get_state())
        got = step(config, params, state, action, generator=g)
        assert_same_step(got, step_plain(config, params, state, action, generator=twin_g))
        assert torch.equal(g.get_state(), twin_g.get_state())
        state = got.state
    assert bool((state.day == 1).all()) and bool((state.t == 1).all())
    assert sum(launch_counts.values()) == 0


@pytest.mark.parametrize("case", ["bf16", "action", "state", "params", "grad", "device"])
def test_engine_step_checks_before_it_launches(case):
    """The kernel's wrapper refuses bf16 params, operands of a wrong shape,
    operands that require grad and params off the card, before it draws from
    the generator, loads a library or launches."""
    config = STEP_CONFIGS["b-pv-sparse"]
    params = make_params(config, torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    state, _ = SmartNanogridTorch(config).reset_batch(params, 4, g)
    action = torch.rand((4, config.num_actions), generator=g)
    args, match = {
        "bf16": ((make_params(config, torch.bfloat16, "cpu"), state, action), "float32 or float64"),
        "action": ((params, state, action[:, :-1]), "action must be"),
        "state": ((params, state._replace(batt_soc=state.batt_soc[:2]), action), "state.batt_soc must be"),
        "params": ((params._replace(rad_norm=params.rad_norm[None]), state, action), "params.rad_norm must be"),
        "grad": ((params, state, action.clone().requires_grad_()), "requires grad"),
        "device": ((params, state, action), "CUDA device"),
    }[case]
    before = g.get_state()
    reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        engine_step(config, *args, generator=g)
    assert sum(launch_counts.values()) == 0 and torch.equal(g.get_state(), before)


def test_physics_matches_on_every_branch():
    rng = np.random.default_rng(1)
    n = 4096
    actions = rng.choice([-1.0, -0.3, 0.0, 0.4, 1.0], n) * rng.random(n)
    actions[::7] = 0.0
    occupied = rng.random(n) < 0.7
    soc = rng.random(n)
    soc[::11] = 0.0
    cap = rng.choice([0.0, 15.0, 40.0, 119.0], n)
    mask = (rng.random(n) < 0.9).astype(np.float64)
    args_j = [jnp.asarray(x) for x in (actions, occupied, soc, cap, mask)]
    args_t = [torch.from_numpy(x) for x in (actions, occupied, soc, cap, mask)]
    consts = (22.0, 0.95, 100.0)
    for dt in (1.0, 2.0, 0.25):
        ref = jax_physics.charger_step(*args_j, *map(jnp.float64, consts), dt)
        got = physics.charger_step(*args_t, *(torch.tensor(c, dtype=F64) for c in consts), dt)
        for name, r, g in zip(ref._fields, ref, got):
            np.testing.assert_allclose(to_numpy(g), np.asarray(r), **TOL, err_msg=name)

        demand = rng.normal(0, 30, n)
        batt = np.concatenate([rng.random(n - 2), [0.0, 1.0]])
        ref = jax_physics.battery_step(jnp.asarray(actions), jnp.asarray(demand), jnp.asarray(batt),
                                       80.0, 44.0, 0.95, dt)
        got = physics.battery_step(torch.from_numpy(actions), torch.from_numpy(demand),
                                   torch.from_numpy(batt), torch.tensor(80.0, dtype=F64),
                                   torch.tensor(44.0, dtype=F64), torch.tensor(0.95, dtype=F64), dt)
        for name, r, g in zip(ref._fields, ref, got):
            np.testing.assert_allclose(to_numpy(g), np.asarray(r), **TOL, err_msg=name)

    req = rng.random((n // 8, 8))
    soc2 = rng.random((n // 8, 8))
    pmask = (rng.random((n // 8, 8)) < 0.5).astype(np.float64)
    ref = jax_physics.vehicle_insufficiency_penalty(jnp.asarray(pmask), jnp.asarray(soc2),
                                                    jnp.asarray(req), 0.05, 10.0)
    got = physics.vehicle_insufficiency_penalty(torch.from_numpy(pmask), torch.from_numpy(soc2),
                                                torch.from_numpy(req), 0.05, 10.0)
    np.testing.assert_allclose(to_numpy(got), np.asarray(ref), **TOL)
    ref = jax_physics.battery_dod_penalty(jnp.asarray(soc), 0.15, 10.0)
    got = physics.battery_dod_penalty(torch.from_numpy(soc), torch.tensor(0.15, dtype=F64), 10.0)
    np.testing.assert_allclose(to_numpy(got), np.asarray(ref), **TOL)
    energy = rng.normal(0, 20, n)
    price = rng.random(n)
    ref = jax_physics.grid_energy_cost(jnp.asarray(energy), jnp.asarray(price), 0.8)
    got = physics.grid_energy_cost(torch.from_numpy(energy), torch.from_numpy(price), 0.8)
    np.testing.assert_allclose(to_numpy(got), np.asarray(ref), **TOL)


CHAIN_CONFIGS = [
    NanogridConfig(num_chargers=4, pv_system=pv, battery_system=pv, penalty_mode=mode,
                   time_interval=dt)
    for pv in (True, False)
    for mode in ("sparse", "dense", "on_departure", "no_penalty")
    for dt in (1.0, 2.0)
] + [
    # off the 1 h and 2 h grid (tests/test_subhourly.py): b-pv, v2x-b-pv and basic
    NanogridConfig(num_chargers=4, pv_system=pv, battery_system=pv, vehicle_to_everything=v2x, time_interval=dt)
    for pv, v2x in ((True, False), (True, True), (False, False))
    for dt in (0.25, 0.5, 1.5)
]


@pytest.mark.parametrize("config", CHAIN_CONFIGS,
                         ids=lambda c: f"{c.variant_name}-{c.penalty_mode.name.lower()}-{c.time_interval:g}h")
def test_step_chain_matches_jax(config):
    """Two days' steps, at least 48, without a reset: the chain crosses day
    ends (pmask lag, PV-shift redraw, battery carry) and the (t-1) mod L
    reads."""
    B = 8
    bparams, jstate, jobs = _jax_states(config, B, seed=2)
    state, params = state_to_torch(jstate), params_to_torch(bparams)
    low, high = config.action_bounds()
    rng = np.random.default_rng(3)
    jstep = jax.jit(jax.vmap(functools.partial(jax_step, config)))
    for _ in range(max(48, 2 * config.steps_per_day)):
        a = rng.uniform(low, high, (B, config.num_actions))
        a[rng.random(a.shape) < 0.15] = 0.0
        ref = jstep(bparams, jstate, jnp.asarray(a))
        got = step(config, params, state, torch.from_numpy(a),
                   next_pv_shift=to_torch(ref.state.pv_shift))
        np.testing.assert_allclose(to_numpy(got.obs), np.asarray(ref.obs), **TOL)
        np.testing.assert_allclose(to_numpy(got.reward), np.asarray(ref.reward), **TOL)
        np.testing.assert_array_equal(to_numpy(got.done), np.asarray(ref.done))
        jstate, state = ref.state, got.state
    for name in ("soc", "batt_soc", "batt_init_soc", "pv_shift", "pmask", "t", "day"):
        np.testing.assert_allclose(to_numpy(getattr(state, name)), np.asarray(getattr(jstate, name)),
                                   **TOL, err_msg=name)
    for name, r, g in zip(ref.info._fields, ref.info, got.info):
        np.testing.assert_allclose(to_numpy(g), np.asarray(r), **TOL, err_msg=name)


def _flax_actor_f64(config, seed):
    net = FlaxActorCritic(action_dim=config.num_actions)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, config.obs_dim), jnp.float32))
    return net, jax.tree.map(lambda x: np.asarray(x, np.float64), params)


@pytest.mark.parametrize("policy", ["rbc", "ppo"])
def test_fused_day_rollout_matches_jax(policy):
    config = NanogridConfig(num_chargers=4, penalty_mode="sparse")
    B = 16
    bparams, jstate, _ = _jax_states(config, B, seed=4)
    if policy == "rbc":
        jax_policy, torch_policy = jax_rbc_fn(config), make_rbc_policy_fn(config)
    else:
        net, flax_params = _flax_actor_f64(config, 5)
        low, high = (jnp.asarray(b, jnp.float64) for b in config.action_bounds())
        jax_policy = lambda o: jnp.clip(net.apply(flax_params, o)[0], low, high)
        torch_policy = make_actor_policy_fn(config, actor_critic_from_flax(flax_params))
    ref_state, (ref_obs, ref_rew, ref_done, ref_info) = jax_fused(
        config, bparams, jstate, lambda o, k: jax_policy(o), jax.random.PRNGKey(6),
        collect_info=True)
    state, (obs, rew, done, info) = fused_day_rollout(
        config, params_to_torch(bparams), state_to_torch(jstate), torch_policy,
        collect_info=True, next_pv_shift=to_torch(ref_state.pv_shift))
    np.testing.assert_allclose(to_numpy(rew), np.asarray(ref_rew), **TOL)
    np.testing.assert_allclose(to_numpy(obs), np.asarray(ref_obs), **TOL)
    np.testing.assert_array_equal(to_numpy(done), np.asarray(ref_done))
    for name, r, g in zip(ref_info._fields, ref_info, info):
        np.testing.assert_allclose(to_numpy(g), np.asarray(r), **TOL, err_msg=name)
    for name in ("soc", "batt_soc", "pmask", "day"):
        np.testing.assert_allclose(to_numpy(getattr(state, name)),
                                   np.asarray(getattr(ref_state, name)), **TOL, err_msg=name)
