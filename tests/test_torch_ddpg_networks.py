"""The port's DDPG networks against flax, the DDPG artifact's numpy copy
against its orbax checkpoint, and the artifact on JAX's 256 evaluation days.

The 256 days are built exactly as the JAX package's
``evaluate_policies_same_days(config, params, ..., num_days=256, seed=0)``
builds them, on the artifact's config in float64; the port scores the
converted states with the converted DDPG actor and the RBC, and per-day
returns must match JAX's at 1e-9 (both packages run the actor in float64).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import make_params as jax_make_params
from smart_nanogrid_gym_tpu.core.config import NanogridConfig as JaxConfig
from smart_nanogrid_gym_tpu.core.transition import reset as jax_reset
from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig as JaxDDPGConfig, DDPGLearner as JaxDDPGLearner
from smart_nanogrid_gym_tpu.solvers.evaluator import evaluate_policies_same_days as jax_evaluate
from smart_nanogrid_gym_tpu.solvers.networks import DDPGActor as FlaxDDPGActor, DDPGCritic as FlaxDDPGCritic
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn as jax_rbc_fn

from smart_nanogrid_gym_torch.core.config import NanogridConfig
from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policies_same_days
from smart_nanogrid_gym_torch.solvers.networks import (
    DDPGActor,
    DDPGCritic,
    ddpg_actor_from_flax,
    ddpg_critic_from_flax,
    ddpg_leaves,
    make_ddpg_policy_fn,
)
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn
from smart_nanogrid_gym_torch.utils.weights import (
    ddpg_state_from_jax,
    ddpg_state_to_jax,
    load_ddpg_actor_npz,
    unflatten,
)

from torch_parity import (
    DDPG_ARTIFACT_DIR,
    DDPG_ARTIFACT_NPZ,
    artifact_config,
    flatten,
    params_to_torch,
    restore_ddpg_artifact,
    state_to_torch,
    to_torch,
)

CONFIGS = {"b-pv-8ch": NanogridConfig(num_chargers=8), "b-pv-4ch": NanogridConfig(num_chargers=4)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ddpg_networks_forward_match_flax(name):
    """Actor and critic forwards at f32 rounding (products of 400 and 300
    terms summed in another order), leaf mapping exercised by non-zero biases."""
    config = CONFIGS[name]
    low, high = config.action_bounds()
    flax_actor = FlaxDDPGActor(config.num_actions, tuple(low.tolist()), tuple(high.tolist()))
    flax_critic = FlaxDDPGCritic()
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(64, config.obs_dim)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(64, config.num_actions)).astype(np.float32)
    with jax.enable_x64(False):
        a_params = flax_actor.init(jax.random.PRNGKey(0), jnp.zeros((1, config.obs_dim), jnp.float32))
        c_params = flax_critic.init(jax.random.PRNGKey(1), jnp.zeros((1, config.obs_dim), jnp.float32),
                                    jnp.zeros((1, config.num_actions), jnp.float32))
        bump = functools.partial(jax.tree_util.tree_map_with_path,
                                 lambda path, x: x + 0.05 if "bias" in str(path) else x)
        a_params, c_params = bump(a_params), bump(c_params)
        a_ref = np.asarray(flax_actor.apply(a_params, jnp.asarray(obs)))
        q_ref = np.asarray(flax_critic.apply(c_params, jnp.asarray(obs), jnp.asarray(act)))
    actor = ddpg_actor_from_flax(jax.tree.map(np.asarray, a_params), low, high)
    critic = ddpg_critic_from_flax(jax.tree.map(np.asarray, c_params), config.obs_dim)
    with torch.no_grad():
        a = actor(torch.from_numpy(obs)).numpy()
        q = critic(torch.from_numpy(obs), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(a, a_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-5)
    assert actor.mu.Dense_1.weight.shape == (300, 400) and critic.q.Dense_0.weight.shape == (400, config.obs_dim
                                                                                               + config.num_actions)
    np.testing.assert_array_equal(make_ddpg_policy_fn(actor)(torch.from_numpy(obs)).numpy(), a)


def test_ddpg_orthogonal_init_has_the_flax_gains():
    """Kernels of fresh DDPG networks have singular values equal to the flax
    gains (√2 hidden, 1.0 output); biases start at zero; a seeded generator
    reproduces the networks."""
    config = CONFIGS["b-pv-8ch"]
    low, high = config.action_bounds()
    actor = DDPGActor(config.obs_dim, config.num_actions, low, high, generator=torch.Generator().manual_seed(0))
    critic = DDPGCritic(config.obs_dim, config.num_actions, generator=torch.Generator().manual_seed(0))
    for net in (actor, critic):
        leaves = ddpg_leaves(net)
        for i, gain in enumerate((np.sqrt(2.0), np.sqrt(2.0), 1.0)):
            w = leaves[2 * i].detach().double().numpy()
            np.testing.assert_allclose(np.linalg.svd(w, compute_uv=False), gain, rtol=1e-5)
            assert not leaves[2 * i + 1].detach().any()
    same = DDPGActor(config.obs_dim, config.num_actions, low, high, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ddpg_leaves(actor), ddpg_leaves(same)))


@pytest.mark.skipif(not os.path.exists(DDPG_ARTIFACT_NPZ), reason="artifact numpy copy absent")
def test_ddpg_artifact_npz_equals_checkpoint():
    """The committed .npz holds the orbax checkpoint (actor params only)
    leaf for leaf."""
    restored = flatten(restore_ddpg_artifact())
    with np.load(DDPG_ARTIFACT_NPZ) as data:
        stored = {k: data[k] for k in data.files}
    assert sorted(stored) == sorted(restored)
    for key, value in restored.items():
        np.testing.assert_array_equal(stored[key], value, err_msg=key)
        assert stored[key].dtype == value.dtype
    config = artifact_config(DDPG_ARTIFACT_DIR)
    net = load_ddpg_actor_npz(DDPG_ARTIFACT_NPZ, config)
    np.testing.assert_array_equal(net.mu.Dense_0.weight.detach().numpy(), stored["params/mu/Dense_0/kernel"].T)
    assert tuple(net.hidden) == (400, 300) and net.obs_dim == config.obs_dim


def test_ddpg_state_round_trip_through_jax_layout():
    config = JaxConfig(num_chargers=4)
    with jax.enable_x64(False):
        learner = JaxDDPGLearner(config, JaxDDPGConfig(buffer_days=1))
        state = learner.init(jax.random.PRNGKey(1), jax_make_params(config, dtype=jnp.float32), batch_size=2)
    trees = jax.tree.map(np.asarray, state)._asdict()
    converted = ddpg_state_from_jax(trees)
    back = ddpg_state_to_jax(*converted)
    for key in ("actor_params", "critic_params", "target_actor_params", "target_critic_params"):
        jax.tree.map(np.testing.assert_array_equal, back[key], trees[key])
    assert back["critic_opt"]["count"] == 0 and converted[0][0].shape == (400, config.obs_dim)
    assert all(not x.any() for x in jax.tree.leaves(back["actor_opt"]["nu"]))


@pytest.mark.skipif(not os.path.exists(DDPG_ARTIFACT_NPZ), reason="artifact numpy copy absent")
def test_ddpg_artifact_matches_jax_on_256_days():
    num_days = 256
    config = artifact_config(DDPG_ARTIFACT_DIR)
    params = jax_make_params(config, dtype=jnp.float64)
    with np.load(DDPG_ARTIFACT_NPZ) as data:
        tree = unflatten({k: data[k].astype(np.float64) for k in data.files})
    low, high = config.action_bounds()
    flax_actor = FlaxDDPGActor(config.num_actions, tuple(low.tolist()), tuple(high.tolist()))
    jax_rbc = jax_rbc_fn(config)
    ref = jax_evaluate(config, params, {
        "ddpg": lambda o, k: flax_actor.apply(tree, o),
        "rbc": lambda o, k: jax_rbc(o),
    }, num_days=num_days, seed=0)

    # the days JAX's evaluator rolled (evaluator.py:52-57)
    env_keys = jax.random.split(jax.random.PRNGKey(0), num_days)
    bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (num_days,) + x.shape), params)
    states0, obs0 = jax.jit(jax.vmap(functools.partial(jax_reset, config)))(bparams, env_keys, None, None)

    net = load_ddpg_actor_npz(DDPG_ARTIFACT_NPZ, config).to(torch.float64)
    got = evaluate_policies_same_days(
        config, params_to_torch(params),
        {"ddpg": make_ddpg_policy_fn(net), "rbc": make_rbc_policy_fn(config)},
        num_days=num_days, states0=state_to_torch(states0), obs0=to_torch(obs0))
    with open(os.path.join(DDPG_ARTIFACT_DIR, "eval.json")) as fp:
        recorded = json.load(fp)
    for name in ("ddpg", "rbc"):
        print(f"{name}: port mean {got[name].mean():.4f}, JAX mean {np.asarray(ref[name]).mean():.4f}, "
              f"eval.json {recorded[name]['mean']}")
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), rtol=1e-9, atol=1e-9, err_msg=name)
    assert got["ddpg"].mean() > got["rbc"].mean()
