"""The collection kernels' twin (K1/K2, ``ops/collect.py``) of the PyTorch
port, with the JAX package as the reference.

K1's twin is held against ``pallas_ppo_collect_day`` in interpret mode on the
same numpy uniforms, normals, PV shifts, batteries and converted
actor-critic, at the tolerances of tests/test_collect_kernel.py:98-109.  K2
draws in-kernel Philox numbers: its twin must equal K1's twin fed the same
draws.  The port's plain engine with the stochastic policy injected through
``policy_xs`` must agree with K1's twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.ops.pallas_collect import pallas_ppo_collect_day
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic

from smart_nanogrid_gym_torch.core.generate import generate_schedule
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.core.rollout import fused_day_rollout
from smart_nanogrid_gym_torch.core.transition import reset
from smart_nanogrid_gym_torch.ops.collect import ppo_collect_day, ppo_collect_day_seeded
from smart_nanogrid_gym_torch.ops.gen_rollout import pv_shift_from_uniform
from smart_nanogrid_gym_torch.ops.philox import collect_draws
from smart_nanogrid_gym_torch.solvers.ppo import _gaussian_logp, apply_actor_critic
from smart_nanogrid_gym_torch.utils.weights import leaves_from_flax

B8 = NanogridConfig(num_chargers=8, pv_system=True, battery_system=True, penalty_mode="sparse")
BASIC4 = NanogridConfig(num_chargers=4, pv_system=False, battery_system=False, penalty_mode="sparse")
TWO_HOUR4 = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True, penalty_mode="sparse",
                           time_interval=2.0)
K1_TOLS = {"obs": (1e-6, 1e-6), "act": (1e-5, 1e-5), "logp": (1e-4, 1e-4), "value": (1e-4, 1e-5),
           "rewards": (1e-5, 1e-5), "batt": (1e-6, 1e-7)}  # tests/test_collect_kernel.py:98-109


def collect_inputs(config, batch, seed):
    """Numpy draws and a flax actor-critic with its 1-d leaves pushed off
    zero (as tests/test_collect_kernel.py does), f32."""
    rng = np.random.default_rng(seed)
    T, N, A = config.steps_per_day, config.num_chargers, config.num_actions
    u = rng.random((T, 5, N, batch)).astype(np.float32)
    normals = rng.standard_normal((T, A, batch)).astype(np.float32)
    pv = (rng.integers(0, 181, batch) / 100.0).astype(np.float32)
    batt = rng.random(batch).astype(np.float32)
    net = FlaxActorCritic(action_dim=A)
    with jax.enable_x64(False):
        flax_params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, config.obs_dim), jnp.float32))
        flax_params = jax.tree.map(lambda x: np.asarray(x + 0.05 if x.ndim == 1 else x), flax_params)
    return u, normals, pv, batt, flax_params


def port_collect(config, inputs):
    u, normals, pv, batt, flax_params = inputs
    return ppo_collect_day(config, make_params(config, torch.float32, "cpu"), leaves_from_flax(flax_params),
                           *(torch.from_numpy(x) for x in (u, normals, pv, batt)))


def test_k1_twin_matches_pallas_collect():
    inputs = collect_inputs(B8, 256, 0)
    u, normals, pv, batt, flax_params = inputs
    with jax.enable_x64(False):
        ref = pallas_ppo_collect_day(B8, jax_make_params(B8, dtype=jnp.float32), flax_params,
                                     *(jnp.asarray(x) for x in (u, normals, pv, batt)), interpret=True)
    got = port_collect(B8, inputs)
    for (name, (rtol, atol)), g, r in zip(K1_TOLS.items(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=atol, err_msg=name)


def test_k1_twin_matches_pallas_collect_two_hours():
    """Off the 1 h grid: 12 steps of 2 h (departure offsets 2/5/0 steps), 4
    chargers, at the smallest batch the JAX kernel takes (128 lanes)."""
    inputs = collect_inputs(TWO_HOUR4, 128, 5)
    u, normals, pv, batt, flax_params = inputs
    with jax.enable_x64(False):
        ref = pallas_ppo_collect_day(TWO_HOUR4, jax_make_params(TWO_HOUR4, dtype=jnp.float32), flax_params,
                                     *(jnp.asarray(x) for x in (u, normals, pv, batt)), interpret=True)
    got = port_collect(TWO_HOUR4, inputs)
    assert got[0].shape == (12, TWO_HOUR4.obs_dim, 128)
    for (name, (rtol, atol)), g, r in zip(K1_TOLS.items(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=atol, err_msg=name)


def test_k1_twin_matches_pallas_collect_no_pv_no_battery():
    inputs = collect_inputs(BASIC4, 128, 7)
    u, normals, pv, batt, flax_params = inputs
    with jax.enable_x64(False):
        ref = pallas_ppo_collect_day(BASIC4, jax_make_params(BASIC4, dtype=jnp.float32), flax_params,
                                     *(jnp.asarray(x) for x in (u, normals, pv, batt)), interpret=True)
    got = port_collect(BASIC4, inputs)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-5, atol=1e-5, err_msg="rewards")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-4, err_msg="logp")


@pytest.mark.parametrize("config", [B8, BASIC4], ids=["b-pv-8ch", "basic-4ch"])
def test_k2_twin_equals_k1_twin_on_its_draws(config):
    *_, flax_params = collect_inputs(config, 8, 3)
    leaves = leaves_from_flax(flax_params)
    params = make_params(config, torch.float32, "cpu")
    batt = torch.linspace(0.1, 0.9, 40)
    seeded = ppo_collect_day_seeded(config, params, leaves, 1234, batt, 40)
    u, normals, u_pv = collect_draws(1234, 40, config.steps_per_day, config.num_chargers,
                                     config.num_actions, "cpu")
    explicit = ppo_collect_day(config, params, leaves, u, normals, pv_shift_from_uniform(u_pv), batt)
    for a, b in zip(seeded, explicit):
        assert torch.equal(a, b)


def test_collect_draws_are_standard_normals_and_fresh_shifts():
    """K2's normals (Box-Muller of Philox uniforms) have mean 0 and std 1
    within their sampling bounds; its PV shifts lie on the reset grid; two
    seeds share no stream."""
    u, normals, u_pv = collect_draws(5, 2048, 24, 8, 9, "cpu")
    n = normals.double()
    bound = 6.0 / np.sqrt(n.numel())
    assert abs(float(n.mean())) < bound
    assert abs(float(n.std()) - 1.0) < 6.0 * np.sqrt(0.5 / n.numel())
    pv = pv_shift_from_uniform(u_pv)
    assert float(pv.min()) >= 0.0 and float(pv.max()) <= 1.8
    assert len(torch.unique(pv)) > 150
    u2, normals2, _ = collect_draws(6, 2048, 24, 8, 9, "cpu")
    assert not torch.equal(u, u2) and not torch.equal(normals, normals2)


@pytest.mark.parametrize("config", [B8, BASIC4], ids=["b-pv-8ch", "basic-4ch"])
def test_plain_engine_policy_aux_matches_k1_twin(config):
    """``fused_day_rollout(policy_aux=True, policy_xs=normals)`` with the
    actor-critic as matrix products records the same trajectory as K1's twin
    (rtol 2e-4: the twin's products run as multiply-add loops)."""
    inputs = collect_inputs(config, 64, 11)
    u, normals, pv, batt, flax_params = inputs
    leaves = leaves_from_flax(flax_params)
    params = make_params(config, torch.float32, "cpu")
    low, high = (torch.as_tensor(b) for b in config.action_bounds())

    def policy(ob, normal):
        mean, log_std, value = apply_actor_critic(leaves, ob)
        action = mean + torch.exp(log_std) * normal
        return torch.clamp(action, low, high), (ob, action, _gaussian_logp(mean, log_std, action), value)

    schedule = generate_schedule(config, params, torch.from_numpy(u).permute(3, 0, 1, 2))
    state, _ = reset(config, params, schedule, batt_soc=torch.from_numpy(batt), pv_shift=torch.from_numpy(pv))
    final, (_, rewards, _, aux) = fused_day_rollout(
        config, params, state, policy, next_pv_shift=state.pv_shift, policy_aux=True,
        policy_xs=torch.from_numpy(normals).permute(0, 2, 1))
    obs, act, logp, value = aux
    got = port_collect(config, inputs)
    want = (obs.permute(0, 2, 1), act.permute(0, 2, 1), logp, value, rewards, final.batt_soc)
    for name, g, w in zip(("obs", "act", "logp", "value", "rewards", "batt"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-4, err_msg=name)


def test_collect_rejects_wrong_shapes():
    inputs = collect_inputs(BASIC4, 16, 1)
    u, normals, pv, batt, flax_params = inputs
    params = make_params(BASIC4, torch.float32, "cpu")
    leaves = leaves_from_flax(flax_params)
    with pytest.raises(ValueError, match="normals"):
        ppo_collect_day(BASIC4, params, leaves, torch.from_numpy(u), torch.from_numpy(normals[:, :2]),
                        torch.from_numpy(pv), torch.from_numpy(batt))
    with pytest.raises(ValueError, match="actor-critic"):
        ppo_collect_day(B8, make_params(B8, torch.float32, "cpu"), leaves,
                        *(torch.from_numpy(x) for x in collect_inputs(B8, 16, 1)[:4]))
