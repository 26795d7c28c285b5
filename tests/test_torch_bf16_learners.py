"""One bf16 update of each learner path of the PyTorch port against the JAX
package's, fed the draws tests/test_torch_ppo.py and tests/test_torch_ddpg.py
feed the f32 updates.

- ``PPOLearner`` plain with ``update_matmul_dtype=bf16`` against
  ``_shard_train_step`` (XLA, flax's bf16 apply inside ``_loss``);
- ``PPOLearner`` kernel (K2's and K3's twins) against
  ``ppo_sweep_pallas_streamed`` with ``SweepHypers(matmul_dtype=bf16)`` in
  interpret mode on the port's collected day (K2's twin meets JAX's K2 in
  tests/test_torch_ppo.py);
- ``DDPGLearner`` kernel (K10's twin) against ``_train_body`` with
  ``sweep_impl="pallas"`` and bf16;
- ``DDPGLearner`` plain with bf16 equals plain f32: the JAX XLA scan never
  reads the option (``_train_body``, ddpg.py:349-389).

The contract is :func:`torch_parity.assert_bf16_close`'s; its f32 reference
is the port's own f32 update, which meets the JAX package's at the f32
tolerance (tests/test_torch_ppo.py, tests/test_torch_ddpg.py).  The master
parameters stay f32 (tests/test_ppo.py:108-109).  The plain PPO path rounds
at flax's points in torch's bf16 kernels, whose backward rounds at points of
its own: 99.6 % of its parameters keep the relation within the f32
tolerance after 4 steps (measured with these inputs); it asserts 99 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smart_nanogrid_gym_tpu.core import make_params as jax_make_params
from smart_nanogrid_gym_tpu.ops.pallas_ppo_sweep import SweepHypers as JaxHypers, ppo_sweep_pallas_streamed
from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig as JaxDDPGConfig, DDPGLearner as JaxDDPGLearner
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig as JaxPPOConfig, PPOLearner as JaxPPOLearner

from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops.collect import ppo_collect_day_seeded
from smart_nanogrid_gym_torch.solvers.ddpg import DDPGConfig, DDPGLearner
from smart_nanogrid_gym_torch.solvers.ppo import PPOConfig, PPOLearner
from smart_nanogrid_gym_torch.utils.weights import ddpg_state_to_jax, leaves_to_flax, ppo_state_to_jax

import test_torch_ddpg
import test_torch_ppo
from torch_parity import assert_bf16_close

BF16 = torch.bfloat16
CFG = test_torch_ppo.CFG
LR = 3e-4


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def ppo_leaves(state):
    return leaves(ppo_state_to_jax(state.params, state.opt_state)[0])


def test_ppo_plain_bf16_update_matches_jax_xla_learner():
    """The plain sweep's flax-style bf16 apply (two roundings per layer:
    product, then bias add; bf16 tanh) against the XLA learner's, after the
    G = 4 steps of one update: rtol 1e-4 as the f32 plain test, every
    parameter within 2·G·lr, the relation for 99 % (module docstring)."""
    B, E, num_mb = 16, 2, 2
    kw = dict(num_epochs=E, num_minibatches=num_mb, minibatch_scheme="env")
    with jax.enable_x64(False):
        jl = JaxPPOLearner(CFG, JaxPPOConfig(**kw, update_matmul_dtype=jnp.bfloat16))
        jstate = jl.init(jax.random.PRNGKey(0), jax_make_params(CFG, dtype=jnp.float32), batch_size=B)
        want, jmet = jl.build_train_step()(jstate, jl.nanogrid_params_batched)
        draws = test_torch_ppo.jax_update_draws(jstate, CFG, B, E, B)
    params = make_params(CFG, torch.float32, "cpu")
    got = {}
    for name, mm in (("bf16", BF16), ("f32", None)):
        learner = PPOLearner(CFG, PPOConfig(**kw, update_matmul_dtype=mm), device="cpu")
        got[name], met = learner.build_train_step()(test_torch_ppo.port_state(learner, jstate, params), params,
                                                    draws)
    assert all(x.dtype == torch.float32 for x in got["bf16"].params + got["bf16"].opt_state.mu)
    assert_bf16_close(ppo_leaves(got["bf16"]), leaves(want.params), ppo_leaves(got["f32"]), 1e-4, 1e-6,
                      2 * E * num_mb * LR, "params", share=0.99)
    np.testing.assert_allclose(float(met.mean_return), float(jmet.mean_return), rtol=1e-5)


def test_ppo_kernel_bf16_update_matches_jax_pallas_sweep():
    """The kernel path (K2's twin, GAE, K3's bf16 twin in the featlane
    layout) against ``ppo_sweep_pallas_streamed(matmul_dtype=bf16)`` on the
    same collected day and block permutation: one step per minibatch, so the
    default contract (rtol 1e-4, bound 2·G·lr)."""
    B = 128
    params = make_params(CFG, torch.float32, "cpu")
    cfg = dict(num_epochs=1, num_minibatches=4, collect_impl="kernel", sweep_impl="kernel")
    got = {}
    for name, mm in (("bf16", BF16), ("f32", None)):
        learner = PPOLearner(CFG, PPOConfig(**cfg, update_matmul_dtype=mm), device="cpu")
        state = learner.init(3, params, B)
        replay = torch.Generator()
        replay.set_state(state.generator.get_state())
        got[name], _ = learner.build_train_step()(state, params)
    assert all(x.dtype == torch.float32 for x in got["bf16"].params)

    T = CFG.steps_per_day
    num_mb, slab, n_bl = learner.kernel_layout(B)
    seed, perms = learner.draw_kernel(replay, n_bl)
    obs, act, logp, val, rew, _ = ppo_collect_day_seeded(CFG, params, state.params, seed, state.batt_soc, B)
    dones = torch.zeros((T, B), dtype=torch.bool)
    dones[-1] = True
    adv, ret = learner._gae(rew, val, dones, torch.zeros(B))
    flax_params = leaves_to_flax(state.params)
    with jax.enable_x64(False):
        zeros = jax.tree.map(jnp.zeros_like, flax_params)
        hp = JaxHypers(lr=LR, clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, max_grad_norm=0.5, matmul_dtype=jnp.bfloat16)
        want = ppo_sweep_pallas_streamed(
            flax_params, jnp.int32(0), zeros, zeros, *(jnp.asarray(x.numpy()) for x in (obs, act, logp, adv, ret)),
            jnp.asarray(perms.reshape(num_mb, n_bl // num_mb).numpy(), jnp.int32), slab, hp,
            interpret=True, data_layout="featlane")[0]
    assert_bf16_close(ppo_leaves(got["bf16"]), leaves(want), ppo_leaves(got["f32"]), 1e-4, 1e-6,
                      2 * num_mb * LR, "params")


DDPG_KW = dict(buffer_days=2, batch_size=32, gradient_steps=2)
DDPG_KEYS = ("actor_params", "critic_params", "target_actor_params", "target_critic_params")


def ddpg_params(state):
    tree = ddpg_state_to_jax(state.actor, state.critic, state.target_actor, state.target_critic, state.actor_opt,
                             state.critic_opt)
    return [x for key in DDPG_KEYS for x in leaves(tree[key])]


def test_ddpg_kernel_bf16_update_matches_jax_pallas_learner():
    """K10's bf16 twin in the learner (400-300 networks, G = 2, M = 32)
    against ``_train_body`` with the Pallas sweep in bf16 (interpret mode),
    both fed the XLA scan's minibatches: the f32 sweep contract's rtol 1e-4 /
    atol 3e-6, every parameter within G·lr."""
    with jax.enable_x64(False):
        jl = JaxDDPGLearner(CFG, JaxDDPGConfig(**DDPG_KW, sweep_impl="pallas", sweep_interpret=True,
                                               update_matmul_dtype=jnp.bfloat16))
        jstate = jl.init(jax.random.PRNGKey(0), jax_make_params(CFG, dtype=jnp.float32), batch_size=test_torch_ddpg.B)
        want, _ = jl._train_body(jstate, jl.nanogrid_params_batched)
        draws = test_torch_ddpg.jax_update_draws(jstate, CFG, jl.cfg, test_torch_ddpg.B)
    params = make_params(CFG, torch.float32, "cpu")
    got = {}
    for name, mm in (("bf16", BF16), ("f32", None)):
        learner = DDPGLearner(CFG, DDPGConfig(**DDPG_KW, sweep_impl="kernel", update_matmul_dtype=mm), device="cpu")
        got[name], _ = learner.build_train_step()(test_torch_ddpg.port_state(learner, jstate, params), params, draws)
    assert all(x.dtype == torch.float32 for x in got["bf16"].actor + got["bf16"].critic)
    assert_bf16_close(ddpg_params(got["bf16"]), [x for k in DDPG_KEYS for x in leaves(getattr(want, k))],
                      ddpg_params(got["f32"]), 1e-4, 3e-6, DDPG_KW["gradient_steps"] * 1e-3, "params")


def test_ddpg_plain_bf16_update_equals_f32():
    """The plain sweep ignores ``update_matmul_dtype``, as the JAX XLA scan
    does: a bf16 update equals the f32 one bit for bit."""
    params = make_params(CFG, torch.float32, "cpu")
    got = []
    for mm in (BF16, None):
        learner = DDPGLearner(CFG, DDPGConfig(**DDPG_KW, update_matmul_dtype=mm), device="cpu")
        state = learner.init(5, params, 8)
        got.append(ddpg_params(learner.build_train_step()(state, params)[0]))
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
