"""The evaluation slice as a whole: the port's evaluator on JAX's days.

JAX builds the 256 evaluation days exactly as its
``evaluate_policies_same_days(config, params, ..., num_days=256, seed=0)``
does, on the committed artifact's config in float64.  The port scores the
converted states with the converted artifact actor, the RBC and the idle
policy; per-day returns must match JAX's at 1e-9.  Both packages run the
actor in float64, so that the comparison is not swamped by f32 rounding of
two different matrix-product orders.
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smart_nanogrid_gym_tpu.core import make_params as jax_make_params
from smart_nanogrid_gym_tpu.core.transition import reset as jax_reset
from smart_nanogrid_gym_tpu.solvers.evaluator import (
    evaluate_policies_same_days as jax_evaluate,
)
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn as jax_rbc_fn

from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policies_same_days
from smart_nanogrid_gym_torch.solvers.networks import make_actor_policy_fn
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn
from smart_nanogrid_gym_torch.utils.weights import load_actor_critic_npz

from torch_parity import ARTIFACT_DIR, ARTIFACT_NPZ, artifact_config, params_to_torch, \
    state_to_torch, to_torch

NUM_DAYS = 256

pytestmark = pytest.mark.skipif(not os.path.exists(ARTIFACT_NPZ), reason="artifact absent")


def test_slice_matches_jax_on_256_days():
    config = artifact_config()
    params = jax_make_params(config, dtype=jnp.float64)
    with np.load(ARTIFACT_NPZ) as data:
        flat = {k: data[k].astype(np.float64) for k in data.files}
    flax_params = {"params": {
        "log_std": flat["params/log_std"],
        **{name: {f"Dense_{i}": {"kernel": flat[f"params/{name}/Dense_{i}/kernel"],
                                 "bias": flat[f"params/{name}/Dense_{i}/bias"]}
                  for i in range(3)} for name in ("pi", "vf")},
    }}
    flax_net = FlaxActorCritic(action_dim=config.num_actions)
    low, high = (jnp.asarray(b, jnp.float64) for b in config.action_bounds())
    jax_rbc = jax_rbc_fn(config)
    ref = jax_evaluate(config, params, {
        "ppo": lambda o, k: jnp.clip(flax_net.apply(flax_params, o)[0], low, high),
        "rbc": lambda o, k: jax_rbc(o),
        "idle": lambda o, k: jnp.zeros(o.shape[:-1] + (config.num_actions,), jnp.float64),
    }, num_days=NUM_DAYS, seed=0)

    # the days JAX's evaluator rolled (evaluator.py:52-57)
    key = jax.random.PRNGKey(0)
    env_keys = jax.random.split(key, NUM_DAYS)
    bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (NUM_DAYS,) + x.shape), params)
    states0, obs0 = jax.jit(jax.vmap(functools.partial(jax_reset, config)))(
        bparams, env_keys, None, None)

    net = load_actor_critic_npz(ARTIFACT_NPZ).to(torch.float64)
    got = evaluate_policies_same_days(
        config, params_to_torch(params), {
            "ppo": make_actor_policy_fn(config, net),
            "rbc": make_rbc_policy_fn(config),
            "idle": lambda o: torch.zeros(o.shape[:-1] + (config.num_actions,), dtype=torch.float64),
        }, num_days=NUM_DAYS, states0=state_to_torch(states0), obs0=to_torch(obs0))

    with open(os.path.join(ARTIFACT_DIR, "eval.json")) as fp:
        recorded = json.load(fp)
    for name in ("ppo", "rbc", "idle"):
        print(f"{name}: port mean {got[name].mean():.4f}, JAX mean {np.asarray(ref[name]).mean():.4f}, "
              f"eval.json {recorded[name]['mean']}")
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), rtol=1e-9, atol=1e-9,
                                   err_msg=name)
    assert got["ppo"].mean() > got["rbc"].mean() > got["idle"].mean()
