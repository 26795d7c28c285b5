"""Tables-in day kernels K11a and K11b of the PyTorch port
(``ops/rollout.py``, ``ops/policy_rollout.py``), with the JAX package as the
reference.

The twins are held against ``pallas_rbc_day_rollout`` and
``pallas_policy_day_rollout`` in interpret mode on the same JAX states
(converted with ``torch_parity.state_to_torch``), fresh and continued into
day 2, at the tolerances tests/test_pallas.py uses: rtol 2e-5 / atol 1e-5
for the RBC, rtol/atol 2e-4 for the actor.  Each twin is also held against
the port's own plain engine (``fused_day_rollout``) at the same tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.core.rollout import fused_day_rollout as jax_fused_day_rollout
from smart_nanogrid_gym_tpu.core.transition import reset as jax_reset
from smart_nanogrid_gym_tpu.ops.pallas_policy_rollout import pallas_policy_day_rollout
from smart_nanogrid_gym_tpu.ops.pallas_rollout import pallas_rbc_day_rollout
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn as jax_rbc_policy_fn

from smart_nanogrid_gym_torch.core import SmartNanogridTorch, fused_day_rollout
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops import policy_day_rollout, rbc_day_rollout
from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_flax, make_actor_policy_fn
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn
from smart_nanogrid_gym_torch.utils.weights import unflatten

from torch_parity import ARTIFACT_NPZ, artifact_config, shifted_flax_actor, state_to_torch

B = 128

RBC_CONFIGS = {
    "b-pv": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "pv-only": NanogridConfig(num_chargers=8, pv_system=True, battery_system=False),
    "basic-dense": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False, penalty_mode="dense"),
}
POLICY_CONFIGS = {
    "b-pv": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "v2x-b-pv": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True, vehicle_to_everything=True),
    "artifact": artifact_config(),
}


def jax_states(config, seed, continued=False):
    """Batched f32 JAX reset states of B envs (as tests/test_pallas.py makes
    them), or the same envs after one plain RBC day, rolled over into day 2."""
    params = jax_make_params(config, dtype=jnp.float32)
    bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), params)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    states, _ = jax.vmap(functools.partial(jax_reset, config))(bparams, keys, None, None)
    if continued:
        rbc = jax_rbc_policy_fn(config)
        states, _ = jax_fused_day_rollout(config, bparams, states, lambda ob, k: rbc(ob), jax.random.PRNGKey(1))
    return bparams, states


def artifact_flax_params():
    with np.load(ARTIFACT_NPZ) as data:
        return unflatten({k: data[k] for k in data.files})


def flax_actor(name, config):
    return artifact_flax_params() if name == "artifact" else shifted_flax_actor(config, 13)


@pytest.mark.parametrize("name, continued", [(n, False) for n in RBC_CONFIGS] + [("b-pv", True)],
                         ids=list(RBC_CONFIGS) + ["b-pv-day2"])
def test_rbc_day_twin_matches_pallas(name, continued):
    config = RBC_CONFIGS[name]
    bparams, states = jax_states(config, 0, continued)
    rew_ref, soc_ref = pallas_rbc_day_rollout(config, bparams, states, interpret=True)
    rew, soc = rbc_day_rollout(config, make_params(config, torch.float32, "cpu"), state_to_torch(states))
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_ref), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(soc.numpy(), np.asarray(soc_ref), rtol=2e-5, atol=1e-5)


def test_rbc_day_twin_takes_batched_params_as_bench_passes_them():
    """bench.py:380-381 calls K11a with params broadcast over the batch;
    the port takes them (every row equal) and matches JAX's kernel there."""
    config = RBC_CONFIGS["b-pv"]
    bparams, states = jax_states(config, 3)
    rew_ref, soc_ref = pallas_rbc_day_rollout(config, bparams, states, interpret=True)
    params = make_params(config, torch.float32, "cpu")
    batched = SmartNanogridTorch(config).broadcast_params(params, B)
    state = state_to_torch(states)
    rew, soc = rbc_day_rollout(config, batched, state)
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_ref), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(soc.numpy(), np.asarray(soc_ref), rtol=2e-5, atol=1e-5)
    net = actor_critic_from_flax(shifted_flax_actor(config, 13))
    got, want = (policy_day_rollout(config, p, state, net) for p in (batched, params))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("name", list(POLICY_CONFIGS))
def test_policy_day_twin_matches_pallas(name):
    config = POLICY_CONFIGS[name]
    flax_params = flax_actor(name, config)
    bparams, states = jax_states(config, 7, continued=name == "b-pv")
    rew_ref, act_ref, soc_ref = pallas_policy_day_rollout(config, bparams, states, flax_params, interpret=True)
    rew, act, soc = policy_day_rollout(config, make_params(config, torch.float32, "cpu"), state_to_torch(states),
                                       actor_critic_from_flax(flax_params))
    for got, want in ((rew, rew_ref), (act, act_ref), (soc, soc_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    low, high = config.action_bounds()
    assert (act.numpy() >= low[None, :, None]).all() and (act.numpy() <= high[None, :, None]).all()


def port_states(config, batch=100):
    """Port reset states and the same envs rolled into day 2 by the plain RBC day."""
    params = make_params(config, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(5)
    state, _ = SmartNanogridTorch(config).reset_batch(params, batch, gen)
    day2, _ = fused_day_rollout(config, params, state, make_rbc_policy_fn(config), generator=gen)
    return params, (state, day2)


@pytest.mark.parametrize("name", ["b-pv", "basic-dense"])
def test_rbc_day_twin_matches_plain_engine(name):
    config = RBC_CONFIGS[name]
    params, states = port_states(config)
    for state in states:
        final, (_, rewards, _) = fused_day_rollout(config, params, state, make_rbc_policy_fn(config),
                                                   next_pv_shift=state.pv_shift)
        rew, soc = rbc_day_rollout(config, params, state)
        torch.testing.assert_close(rew, rewards, rtol=2e-5, atol=1e-5)
        torch.testing.assert_close(soc, final.soc[..., config.steps_per_day - 1].T, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["v2x-b-pv", "artifact"])
def test_policy_day_twin_matches_plain_engine(name):
    config = POLICY_CONFIGS[name]
    net = actor_critic_from_flax(flax_actor(name, config))
    params, states = port_states(config)
    for state in states:
        final, (_, rewards, _) = fused_day_rollout(config, params, state, make_actor_policy_fn(config, net),
                                                   next_pv_shift=state.pv_shift)
        rew, _, soc = policy_day_rollout(config, params, state, net)
        torch.testing.assert_close(rew, rewards, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(soc, final.soc[..., config.steps_per_day - 1].T, rtol=2e-4, atol=2e-4)


def test_tables_in_wrappers_reject_what_the_kernels_do_not_take():
    config = RBC_CONFIGS["b-pv"]
    params, (state, _) = port_states(config, batch=8)
    net = actor_critic_from_flax(shifted_flax_actor(config, 3))
    mid_day = state._replace(t=torch.where(torch.arange(8) == 3, 5, 0))
    with pytest.raises(ValueError, match="state.t == 0"):
        rbc_day_rollout(config, params, mid_day)
    with pytest.raises(ValueError, match="state.t == 0"):
        policy_day_rollout(config, params, mid_day, net)
    hetero = SmartNanogridTorch(config).broadcast_params(params, 8)
    hetero = hetero._replace(price=hetero.price.clone())
    hetero.price[3] += 1.0
    with pytest.raises(ValueError, match="price differ across envs"):
        rbc_day_rollout(config, hetero, state)
    with pytest.raises(ValueError, match="price differ across envs"):
        policy_day_rollout(config, hetero, state, net)
    with pytest.raises(ValueError, match="non-v2x"):
        rbc_day_rollout(POLICY_CONFIGS["v2x-b-pv"], params, state)
    short = NanogridConfig(num_chargers=8, lookahead=2)
    with pytest.raises(ValueError, match="lookahead"):
        policy_day_rollout(short, make_params(short, torch.float32, "cpu"), state, net)
    bad = params._replace(penalty_gain=params.penalty_gain * 2)
    with pytest.raises(ValueError, match="penalty_gain"):
        rbc_day_rollout(config, bad, state)
