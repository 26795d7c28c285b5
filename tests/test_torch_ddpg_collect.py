"""The DDPG collection kernel's twin (K9, ``ops/ddpg_collect.py``), with
the JAX package as the reference.

K9's twin is held against ``pallas_ddpg_collect_day`` in interpret mode at
tests/test_collect_kernel.py:182-191's tolerances, and against the port's
plain engine with the OU noise fed through ``policy_xs``.  K9 seeded draws
in-kernel Philox numbers: its twin must equal the explicit twin fed the same
draws, and K9 seeded and K2 generate the same day at the same seed.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.ops.pallas_collect import pallas_ddpg_collect_day

from smart_nanogrid_gym_torch.core.generate import generate_schedule
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.core.rollout import fused_day_rollout
from smart_nanogrid_gym_torch.core.transition import reset
from smart_nanogrid_gym_torch.ops.collect import ppo_collect_day_seeded
from smart_nanogrid_gym_torch.ops.ddpg_collect import (
    check_collect_block,
    ddpg_collect_day,
    ddpg_collect_day_seeded,
    ddpg_weights,
    k9_block,
)
from smart_nanogrid_gym_torch.ops._build import MAX_SHARED_BYTES
from smart_nanogrid_gym_torch.ops.gen_policy_rollout import trace_floats
from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces, pv_shift_from_uniform
from smart_nanogrid_gym_torch.ops.philox import collect_day_draws, collect_draws
from smart_nanogrid_gym_torch.solvers.ddpg import actor_apply
from smart_nanogrid_gym_torch.solvers.networks import mlp_leaves_from_flax

from torch_parity import flax_ddpg_actor

B8 = NanogridConfig(num_chargers=8, pv_system=True, battery_system=True, penalty_mode="sparse")
ART4 = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True, penalty_mode="sparse")
TWO_HOUR4 = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True, penalty_mode="sparse",
                           time_interval=2.0)
K9_TOLS = {"obs": (1e-6, 1e-6), "act": (1e-5, 1e-5), "rewards": (1e-5, 1e-5), "next_obs": (1e-5, 1e-5),
           "batt": (1e-5, 1e-6)}  # tests/test_collect_kernel.py:182-191


def collect_inputs(config, batch, seed):
    rng = np.random.default_rng(seed)
    T, N, A = config.steps_per_day, config.num_chargers, config.num_actions
    u = rng.random((T, 5, N, batch)).astype(np.float32)
    ou = (0.3 * rng.standard_normal((T, A, batch))).astype(np.float32)
    pv = (rng.integers(0, 181, batch) / 100.0).astype(np.float32)
    batt = rng.random(batch).astype(np.float32)
    return u, ou, pv, batt, flax_ddpg_actor(config, seed, hidden=(64, 48), shift=False)


def test_k9_twin_matches_pallas_ddpg_collect():
    u, ou, pv, batt, flax_params = collect_inputs(B8, 128, 3)
    with jax.enable_x64(False):
        ref = pallas_ddpg_collect_day(B8, jax_make_params(B8, dtype=jnp.float32), flax_params,
                                      *(jnp.asarray(x) for x in (u, ou, pv, batt)), interpret=True)
    got = ddpg_collect_day(B8, make_params(B8, torch.float32, "cpu"), mlp_leaves_from_flax(flax_params, "mu"),
                           *(torch.from_numpy(x) for x in (u, ou, pv, batt)))
    for (name, (rtol, atol)), g, r in zip(K9_TOLS.items(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=atol, err_msg=name)


def test_k9_twin_matches_pallas_ddpg_collect_two_hours():
    """Off the 1 h grid: 12 steps of 2 h (departure offsets 2/5/0 steps), 4
    chargers, at the smallest batch the JAX kernel takes (128 lanes)."""
    u, ou, pv, batt, flax_params = collect_inputs(TWO_HOUR4, 128, 4)
    with jax.enable_x64(False):
        ref = pallas_ddpg_collect_day(TWO_HOUR4, jax_make_params(TWO_HOUR4, dtype=jnp.float32), flax_params,
                                      *(jnp.asarray(x) for x in (u, ou, pv, batt)), interpret=True)
    got = ddpg_collect_day(TWO_HOUR4, make_params(TWO_HOUR4, torch.float32, "cpu"),
                           mlp_leaves_from_flax(flax_params, "mu"), *(torch.from_numpy(x) for x in (u, ou, pv, batt)))
    assert got[0].shape == (12, TWO_HOUR4.obs_dim, 128)
    for (name, (rtol, atol)), g, r in zip(K9_TOLS.items(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=atol, err_msg=name)


def test_k9_twin_matches_the_plain_engine_with_ou_through_policy_xs():
    """The plain engine's fused day with the DDPG actor plus OU noise fed
    through ``policy_xs`` records the same transitions as K9's twin
    (rtol 2e-4: the twin's products run as multiply-add loops)."""
    config = ART4
    u, ou, pv, batt, flax_params = collect_inputs(config, 64, 5)
    leaves = mlp_leaves_from_flax(flax_params, "mu")
    params = make_params(config, torch.float32, "cpu")
    low, high = (torch.as_tensor(b) for b in config.action_bounds())

    def policy(ob, ou_t):
        a = torch.clamp(actor_apply(leaves, ob, low, high) + ou_t, low, high)
        return a, (ob, a)

    schedule = generate_schedule(config, params, torch.from_numpy(u).permute(3, 0, 1, 2))
    state, _ = reset(config, params, schedule, batt_soc=torch.from_numpy(batt), pv_shift=torch.from_numpy(pv))
    final, (obs_traj, rewards, _, (obs, act)) = fused_day_rollout(
        config, params, state, policy, next_pv_shift=state.pv_shift, policy_aux=True,
        policy_xs=torch.from_numpy(ou).permute(0, 2, 1))
    got = ddpg_collect_day(config, params, leaves, *(torch.from_numpy(x) for x in (u, ou, pv, batt)))
    want = (obs.permute(0, 2, 1), act.permute(0, 2, 1), rewards, obs_traj.permute(0, 2, 1), final.batt_soc)
    for name, g, w in zip(("obs", "act", "rewards", "next_obs", "batt"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("config", [B8, ART4], ids=["b-pv-8ch", "artifact-4ch"])
def test_k9_seeded_twin_equals_explicit_twin_and_shares_k2s_day(config):
    *_, flax_params = collect_inputs(config, 8, 7)
    leaves = mlp_leaves_from_flax(flax_params, "mu")
    params = make_params(config, torch.float32, "cpu")
    batt = torch.linspace(0.1, 0.9, 40)
    ou = 0.2 * torch.randn((config.steps_per_day, config.num_actions, 40), generator=torch.Generator().manual_seed(1))
    seeded = ddpg_collect_day_seeded(config, params, leaves, 1234, ou, batt, 40)
    u, u_pv = collect_day_draws(1234, 40, config.steps_per_day, config.num_chargers, "cpu")
    explicit = ddpg_collect_day(config, params, leaves, u, ou, pv_shift_from_uniform(u_pv), batt)
    for a, b in zip(seeded, explicit):
        assert torch.equal(a, b)
    u2, _, u_pv2 = collect_draws(1234, 40, config.steps_per_day, config.num_chargers, config.num_actions, "cpu")
    assert torch.equal(u, u2) and torch.equal(u_pv, u_pv2)
    # the same day under K2: the first observation, which no action has touched, agrees
    k2_obs = ppo_collect_day_seeded(config, params, _ppo_leaves(config), 1234, batt, 40)[0]
    assert torch.equal(k2_obs[0], seeded[0][0])


def _ppo_leaves(config):
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic, actor_critic_leaves

    net = ActorCritic(config.obs_dim, config.num_actions, generator=torch.Generator().manual_seed(0))
    return [x.detach() for x in actor_critic_leaves(net)]


def test_k9_rejects_wrong_shapes():
    u, ou, pv, batt, flax_params = collect_inputs(ART4, 16, 1)
    params = make_params(ART4, torch.float32, "cpu")
    leaves = mlp_leaves_from_flax(flax_params, "mu")
    with pytest.raises(ValueError, match="ou_seq"):
        ddpg_collect_day(ART4, params, leaves, torch.from_numpy(u), torch.from_numpy(ou[:, :2]),
                         torch.from_numpy(pv), torch.from_numpy(batt))
    with pytest.raises(ValueError, match="config needs"):
        ddpg_weights(B8, leaves, torch.device("cpu"))


def test_k9_block_holds_w1_and_w2_k_major():
    """K9 streams W1 and W2 k-major through its shared-memory ring, each chunk
    one bulk copy: the block holds their transposes with each k-row padded
    with zeros to 8 (W1) and 4 (W2) floats, then b1, b2, W3, b3 and the box;
    the library's size is checked, and so is the block's shared memory
    against the size the library reports."""
    flax_params = flax_ddpg_actor(ART4, 2, hidden=(50, 30), shift=False)
    w = ddpg_weights(ART4, mlp_leaves_from_flax(flax_params, "mu"), torch.device("cpu"))
    (H1, F), H2 = w.w1.shape, w.w2.shape[0]
    P1, P2 = 56, 32
    tail = torch.cat([x.reshape(-1) for x in (w.b1, w.b2, w.w3, w.b3, w.low, w.high)])
    size = F * P1 + H1 * P2 + tail.numel()
    block = k9_block(w, SimpleNamespace(ngk_collect_weights_size=lambda: size))
    w1 = block[:F * P1].reshape(F, P1)
    w2 = block[F * P1:F * P1 + H1 * P2].reshape(H1, P2)
    assert torch.equal(w1[:, :H1], w.w1.T) and not w1[:, H1:].any()
    assert torch.equal(w2[:, :H2], w.w2.T) and not w2[:, H2:].any()
    assert torch.equal(block[F * P1 + H1 * P2:], tail)
    with pytest.raises(ValueError, match="expects"):
        k9_block(w, SimpleNamespace(ngk_collect_weights_size=lambda: size + 1))
    traces = kernel_traces(make_params(B8, torch.float32, "cpu"), "cpu")
    room = MAX_SHARED_BYTES // 4 - trace_floats(B8, traces)
    check_collect_block(B8, traces, SimpleNamespace(ngk_collect_smem_floats=lambda: room), (400, 300))
    with pytest.raises(ValueError, match="shared memory"):
        check_collect_block(B8, traces, SimpleNamespace(ngk_collect_smem_floats=lambda: room + 1), (1024, 1024))
