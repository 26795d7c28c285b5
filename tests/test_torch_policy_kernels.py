"""Kernel twins K5 and K6 of the PyTorch port (``ops/gen_policy_rollout.py``),
with the JAX package as the reference.

K5's twin is held against ``pallas_gen_policy_day`` in interpret mode on the
same numpy uniforms, PV shifts and (bias-shifted) actor weights, at the
tolerance tests/test_pallas.py uses, for both actors: ``actor="ppo"`` and
``actor="ddpg"`` (the DDPG actor on 8-charger b-pv and on the DDPG
artifact's 4-charger config).  K6 draws in-kernel Philox numbers: its
twin is held against K5's twin fed the same draws, with the battery carried
from one day to the next.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.ops.pallas_gen_policy_rollout import pallas_gen_policy_day

from smart_nanogrid_gym_torch.core.generate import generate_schedule
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.core.rollout import fused_day_rollout
from smart_nanogrid_gym_torch.core.transition import reset
from smart_nanogrid_gym_torch.ops import gen_policy_day
from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
    actor_weights,
    check_k6_block,
    gen_policy_day_plain,
    gen_policy_multiday_plain,
)
from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces, pv_shift_from_uniform
from smart_nanogrid_gym_torch.ops.philox import day_uniforms
from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policy_at_scale
from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_flax, ddpg_actor_from_flax, \
    make_actor_policy_fn

from torch_parity import flax_ddpg_actor, kernel_inputs, shifted_flax_actor
from test_torch_k6_block import k6_layout

B = 128

POLICY_CONFIGS = {
    "b-pv": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "v2x-b-pv": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                               vehicle_to_everything=True),
    "v2x": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False,
                          vehicle_to_everything=True, penalty_mode="dense"),
}


@pytest.mark.parametrize("name", list(POLICY_CONFIGS))
def test_policy_day_twin_matches_pallas(name):
    config = POLICY_CONFIGS[name]
    u, pv = kernel_inputs(config, 11, B)
    flax_params = shifted_flax_actor(config, 13)
    with jax.enable_x64(False):
        params = jax_make_params(config, dtype=jnp.float32)
        rew_ref, act_ref, soc_ref, batt_ref = pallas_gen_policy_day(
            config, params, flax_params, jnp.asarray(u), jnp.asarray(pv), interpret=True)
    net = actor_critic_from_flax(flax_params)
    rew, act, soc, batt = gen_policy_day(config, make_params(config, torch.float32, "cpu"), net,
                                         torch.from_numpy(u), torch.from_numpy(pv))
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(batt.numpy(), np.asarray(batt_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(act.numpy(), np.asarray(act_ref), rtol=2e-4, atol=2e-4)
    assert soc.shape == (config.num_chargers, B)
    np.testing.assert_allclose(soc.numpy(), np.asarray(soc_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(POLICY_CONFIGS))
def test_policy_day_twin_matches_plain_engine(name):
    """K5's twin against the port's own engine with the same actor as an
    ``nn.Module`` (its products go through ``nn.Linear``), in f32."""
    config = POLICY_CONFIGS[name]
    u, pv = kernel_inputs(config, 17, 64)
    params = make_params(config, torch.float32, "cpu")
    net = actor_critic_from_flax(shifted_flax_actor(config, 19))
    schedule = generate_schedule(config, params, torch.from_numpy(u).permute(3, 0, 1, 2))
    state, _ = reset(config, params, schedule, pv_shift=torch.from_numpy(pv))
    final, (_, rewards, _) = fused_day_rollout(config, params, state,
                                               make_actor_policy_fn(config, net),
                                               next_pv_shift=state.pv_shift)
    rew, _, soc, batt = gen_policy_day(config, params, net, torch.from_numpy(u), torch.from_numpy(pv))
    np.testing.assert_allclose(rew.numpy(), rewards.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(soc.numpy(), final.soc[..., config.steps_per_day - 1].T.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(batt.numpy(), final.batt_soc.numpy(), rtol=2e-4, atol=2e-4)


def test_policy_multiday_twin_equals_explicit_days():
    config = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
    traces = kernel_traces(make_params(config, torch.float32, "cpu"), torch.device("cpu"))
    weights = actor_weights(config, actor_critic_from_flax(shifted_flax_actor(config, 21)),
                            torch.device("cpu"))
    stats = gen_policy_multiday_plain(config, traces, weights, num_days=2, seed=4, batch=64)
    batt = torch.full((64,), 0.5)
    returns = []
    for day in range(2):
        u, u_pv = day_uniforms(4, day, 64, 24, 4, "cpu")
        rew, _, _, batt = gen_policy_day_plain(config, traces, weights, u,
                                               pv_shift_from_uniform(u_pv), batt)
        returns.append(rew.sum(0, dtype=torch.float64))
    days = torch.stack(returns)
    np.testing.assert_allclose(stats[0].double().numpy(), days.sum(0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(stats[1].double().numpy(), (days ** 2).sum(0).numpy(), rtol=1e-5)
    np.testing.assert_array_equal(stats[2].numpy(), batt.numpy())


DDPG_CONFIGS = {
    "b-pv-8ch": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True, penalty_mode="sparse"),
    "artifact-4ch": NanogridConfig(num_chargers=4, pv_system=True, battery_system=True, penalty_mode="sparse"),
}
ART4 = DDPG_CONFIGS["artifact-4ch"]
NARROW = (64, 48)  # the DDPG torso at test width; the card's tests run 400-300


def port_actor(config, flax_params):
    low, high = config.action_bounds()
    return ddpg_actor_from_flax(flax_params, low, high)


@pytest.mark.parametrize("name", list(DDPG_CONFIGS))
def test_ddpg_policy_day_twin_matches_pallas(name):
    config = DDPG_CONFIGS[name]
    u, pv = kernel_inputs(config, 11, 128)
    flax_params = flax_ddpg_actor(config, 23, hidden=NARROW)
    with jax.enable_x64(False):
        ref = pallas_gen_policy_day(config, jax_make_params(config, dtype=jnp.float32), flax_params,
                                    jnp.asarray(u), jnp.asarray(pv), interpret=True, actor="ddpg")
    got = gen_policy_day(config, make_params(config, torch.float32, "cpu"), port_actor(config, flax_params),
                         torch.from_numpy(u), torch.from_numpy(pv), actor="ddpg")
    for name, g, r in zip(("rewards", "actions", "soc", "batt"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4, err_msg=name)
    low, high = config.action_bounds()
    a = got[1].numpy()
    assert (a >= low[None, :, None]).all() and (a <= high[None, :, None]).all()


def test_ddpg_policy_multiday_twin_equals_explicit_days():
    """K6's DDPG twin equals K5's DDPG twin fed the same Philox days with the
    battery carried; ``evaluate_policy_at_scale(algorithm="ddpg")`` reads it."""
    config = ART4
    params = make_params(config, torch.float32, "cpu")
    traces = kernel_traces(params, torch.device("cpu"))
    net = port_actor(config, flax_ddpg_actor(config, 29, hidden=NARROW))
    weights = actor_weights(config, net, torch.device("cpu"), actor="ddpg")
    stats = gen_policy_multiday_plain(config, traces, weights, 2, 4, 32, actor="ddpg")
    batt = torch.full((32,), 0.5)
    returns = []
    for day in range(2):
        u, u_pv = day_uniforms(4, day, 32, 24, 4, "cpu")
        rew, _, _, batt = gen_policy_day_plain(config, traces, weights, u, pv_shift_from_uniform(u_pv), batt,
                                               actor="ddpg")
        returns.append(rew.sum(0, dtype=torch.float64))
    days = torch.stack(returns)
    np.testing.assert_allclose(stats[0].double().numpy(), days.sum(0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(stats[1].double().numpy(), (days ** 2).sum(0).numpy(), rtol=1e-5)
    np.testing.assert_array_equal(stats[2].numpy(), batt.numpy())
    res = evaluate_policy_at_scale(config, params, net, 2, 32, seed=4, algorithm="ddpg")
    np.testing.assert_allclose(res["mean_day_return"], float(days.mean()), rtol=1e-5)


def test_ddpg_actor_option_rejects_the_wrong_network_and_large_torsos():
    params = make_params(ART4, torch.float32, "cpu")
    net = port_actor(ART4, flax_ddpg_actor(ART4, 3))
    u, pv = kernel_inputs(ART4, 1, 8)
    with pytest.raises(ValueError, match="ActorCritic"):
        gen_policy_day(ART4, params, net, torch.from_numpy(u), torch.from_numpy(pv), actor="ppo")
    with pytest.raises(ValueError, match="actor must be"):
        gen_policy_day(ART4, params, net, torch.from_numpy(u), torch.from_numpy(pv), actor="sac")
    traces = kernel_traces(params, torch.device("cpu"))
    for hidden in ((400, 300), (1024, 1024)):  # the block actor's layout with K11b's table slots
        lib = SimpleNamespace(ngk_k11b_smem_floats=lambda h=hidden: k6_layout(ART4, h, kinds=7)[0])
        if hidden[0] < 1024:
            check_k6_block(ART4, traces, lib, hidden, False, tables=True)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                check_k6_block(ART4, traces, lib, hidden, False, tables=True)


