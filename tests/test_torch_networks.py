"""The port's ActorCritic against flax, and the artifact's numpy copy against
its orbax checkpoint."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic
from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_flax
from smart_nanogrid_gym_torch.utils.weights import load_actor_critic_npz, unflatten

from torch_parity import ARTIFACT_NPZ, flatten, restore_artifact


@pytest.mark.parametrize("dims", [(25, 9), (17, 5)], ids=["b-pv-8ch", "b-pv-4ch"])
def test_actor_critic_forward_matches_flax(dims):
    obs_dim, action_dim = dims
    flax_net = FlaxActorCritic(action_dim=action_dim)
    params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim), jnp.float32))
    # a non-zero log_std, so that the leaf mapping is exercised too
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.25 if "log_std" in str(path) else x, params)
    obs = np.random.default_rng(1).normal(size=(64, obs_dim)).astype(np.float32)
    with jax.enable_x64(False):
        mean, log_std, value = flax_net.apply(params, jnp.asarray(obs))
    net = actor_critic_from_flax(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        t_mean, t_log_std, t_value = net(torch.from_numpy(obs))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_value.numpy(), np.asarray(value), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t_log_std.detach().numpy(), np.asarray(log_std))
    assert net.pi.Dense_0.weight.shape == (64, obs_dim)


@pytest.mark.skipif(not os.path.exists(ARTIFACT_NPZ), reason="artifact numpy copy absent")
def test_artifact_npz_equals_checkpoint():
    """The committed .npz holds the orbax checkpoint leaf for leaf."""
    restored = flatten(restore_artifact())
    with np.load(ARTIFACT_NPZ) as data:
        stored = {k: data[k] for k in data.files}
    assert sorted(stored) == sorted(restored)
    for key, value in restored.items():
        np.testing.assert_array_equal(stored[key], value, err_msg=key)
        assert stored[key].dtype == value.dtype
    net = load_actor_critic_npz(ARTIFACT_NPZ)
    np.testing.assert_array_equal(net.pi.Dense_0.weight.detach().numpy(),
                                  stored["params/pi/Dense_0/kernel"].T)
    assert unflatten({"a/b/c": 1, "a/d": 2}) == {"a": {"b": {"c": 1}, "d": 2}}
