"""K6's bf16 operand option (``mlp_dtype``) and the 256×256 PPO torso in the
PyTorch port's day-kernel twins, with the JAX package as the reference.

JAX's K6 draws with the TPU's hardware PRNG and does not run here; its step
body is held instead: ``pallas_gen_policy_day`` in interpret mode with the
module's ``_actor_blocks`` patched to bf16 weights, which is the path
``_gen_policy_step`` takes under K6's ``mlp_dtype``.  The bf16 contract is
:func:`torch_parity.assert_bf16_close`'s; its f32 reference is the port's
f32 twin, which meets JAX's f32 kernel at the f32 tolerance
(tests/test_torch_policy_kernels.py).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smart_nanogrid_gym_tpu.ops.pallas_gen_policy_rollout as jax_policy
from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic

from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops._build import MAX_SHARED_BYTES
from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
    actor_weights,
    check_collect_block,
    check_k6_block,
    gen_policy_day_plain,
    gen_policy_multiday,
    gen_policy_multiday_plain,
    trace_floats,
)
from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces, pv_shift_from_uniform
from smart_nanogrid_gym_torch.ops.philox import day_uniforms
from smart_nanogrid_gym_torch.solvers.networks import ActorCritic, actor_critic_from_flax, ddpg_actor_from_flax

from torch_parity import assert_bf16_close, flax_ddpg_actor, kernel_inputs, shifted_flax_actor
from test_torch_k6_block import k6_layout

BF16 = torch.bfloat16
B8 = NanogridConfig(num_chargers=8, pv_system=True, battery_system=True)
NARROW = (64, 48)  # the DDPG torso at test width; the card runs 400-300
ACTOR_BLOCKS = jax_policy._actor_blocks
CPU = torch.device("cpu")


@pytest.mark.parametrize("actor", ["ppo", "ddpg"])
def test_k6_bf16_step_body_matches_pallas(actor, monkeypatch):
    """K6's step body under ``mlp_dtype=bf16`` on the 8-charger b-pv config,
    B=128: the PPO 64×64 and the DDPG test-width torsos, against
    ``pallas_gen_policy_day`` with bf16 weight blocks.  Tolerance: rtol and
    atol 2e-4 as the f32 policy tests; bound 0.01 (a rounding flip of one
    hidden unit moves an action by about 2^-8 of its range)."""
    u, pv = kernel_inputs(B8, 11, 128)
    if actor == "ppo":
        flax_params = shifted_flax_actor(B8, 13)
        net = actor_critic_from_flax(flax_params)
    else:
        flax_params = flax_ddpg_actor(B8, 23, hidden=NARROW)
        net = ddpg_actor_from_flax(flax_params, *B8.action_bounds())
    with monkeypatch.context() as m, jax.enable_x64(False):
        m.setattr(jax_policy, "_actor_blocks", functools.partial(ACTOR_BLOCKS, mlp_dtype=jnp.bfloat16))
        want = jax_policy.pallas_gen_policy_day(B8, jax_make_params(B8, dtype=jnp.float32), flax_params,
                                                jnp.asarray(u), jnp.asarray(pv), interpret=True, actor=actor)
    traces = kernel_traces(make_params(B8, torch.float32, "cpu"), CPU)
    args = (torch.from_numpy(u), torch.from_numpy(pv), torch.full((128,), 0.5), actor)
    got = gen_policy_day_plain(B8, traces, actor_weights(B8, net, CPU, actor, mlp_dtype=BF16), *args, mlp_dtype=BF16)
    f32 = gen_policy_day_plain(B8, traces, actor_weights(B8, net, CPU, actor), *args)
    assert_bf16_close(got, want, f32, 2e-4, 2e-4, 0.01, "rewards, actions, soc, batt")


def test_k6_bf16_twin_equals_explicit_days():
    """K6's bf16 twin equals the bf16 step body fed the same Philox days with
    the battery carried (the final battery bit for bit), and differs from
    the f32 twin."""
    config = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
    traces = kernel_traces(make_params(config, torch.float32, "cpu"), CPU)
    net = actor_critic_from_flax(shifted_flax_actor(config, 21))
    weights = actor_weights(config, net, CPU, mlp_dtype=BF16)
    stats = gen_policy_multiday_plain(config, traces, weights, 2, 4, 64, mlp_dtype=BF16)
    batt, returns = torch.full((64,), 0.5), []
    for day in range(2):
        u, u_pv = day_uniforms(4, day, 64, 24, 4, "cpu")
        rew, _, _, batt = gen_policy_day_plain(config, traces, weights, u, pv_shift_from_uniform(u_pv), batt,
                                               mlp_dtype=BF16)
        returns.append(rew.sum(0, dtype=torch.float64))
    days = torch.stack(returns)
    np.testing.assert_allclose(stats[0].double().numpy(), days.sum(0).numpy(), rtol=1e-5)
    np.testing.assert_array_equal(stats[2].numpy(), batt.numpy())
    assert not torch.equal(stats, gen_policy_multiday_plain(config, traces, actor_weights(config, net, CPU), 2, 4, 64))


def test_k5_twin_at_256x256_matches_pallas():
    """The bench's 256×256 PPO torso (biases +0.05, tests/test_tpu_kernels.py:
    238-240) on the 8-charger config in f32, B=128, at the f32 policy tests'
    tolerance."""
    u, pv = kernel_inputs(B8, 31, 128)
    with jax.enable_x64(False):
        net = FlaxActorCritic(action_dim=B8.num_actions, hidden=(256, 256))
        flax_params = net.init(jax.random.PRNGKey(42), jnp.zeros((1, B8.obs_dim), jnp.float32))
        flax_params = jax.tree.map(lambda x: x + 0.05 if x.ndim == 1 else x, flax_params)
        want = jax_policy.pallas_gen_policy_day(B8, jax_make_params(B8, dtype=jnp.float32), flax_params,
                                                jnp.asarray(u), jnp.asarray(pv), interpret=True)
    port = actor_critic_from_flax(jax.tree.map(np.asarray, flax_params))
    assert port.hidden == (256, 256)
    traces = kernel_traces(make_params(B8, torch.float32, "cpu"), CPU)
    got = gen_policy_day_plain(B8, traces, actor_weights(B8, port, CPU), torch.from_numpy(u),
                               torch.from_numpy(pv), torch.full((128,), 0.5))
    for name, g, w in zip(("rewards", "actions", "soc", "batt"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4, err_msg=name)


def test_torso_limits_raise_before_any_launch():
    """K6 refuses h1 + h2 > 768 as the JAX kernel does (on the CPU too, before
    any launch); the block actor's shared-memory check (K11b's instance, its
    table slots in the layout) names its limit; the
    collection kernels refuse a block whose shared memory, as the kernel
    library reports it, and the traces exceed a block's (the 256×256
    actor-critic on the card: tests/test_torch_cuda.py)."""
    params = make_params(B8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="768"):
        gen_policy_multiday(B8, params, ActorCritic(B8.obs_dim, B8.num_actions, (512, 512)), 1, 0, 8)
    assert gen_policy_multiday(B8, params, ActorCritic(B8.obs_dim, B8.num_actions, (384, 384)), 1, 0, 8,
                               mlp_dtype=BF16).shape == (3, 8)
    traces = kernel_traces(params, CPU)
    for hidden in ((256, 256), (1024, 1024)):  # K11b's instance of the block actor, its floats as reported
        lib = SimpleNamespace(ngk_k11b_smem_floats=lambda h=hidden: k6_layout(B8, h, kinds=7)[0])
        if hidden[0] < 1024:
            check_k6_block(B8, traces, lib, hidden, False, tables=True)
        else:
            with pytest.raises(ValueError, match="232448"):
                check_k6_block(B8, traces, lib, hidden, False, tables=True)
    room = MAX_SHARED_BYTES // 4 - trace_floats(B8, traces)
    check_collect_block(B8, traces, SimpleNamespace(ngk_collect_smem_floats=lambda: room), (64, 64))
    with pytest.raises(ValueError, match="collect_impl='plain'"):
        check_collect_block(B8, traces, SimpleNamespace(ngk_collect_smem_floats=lambda: room + 1), (256, 256))
    with pytest.raises(ValueError, match="operand dtype"):
        gen_policy_multiday(B8, params, ActorCritic(B8.obs_dim, B8.num_actions), 1, 0, 8, mlp_dtype=torch.float16)
