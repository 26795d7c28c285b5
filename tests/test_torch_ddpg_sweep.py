"""The DDPG sweep's twin (K10, ``ops/ddpg_sweep.py``) against the JAX
package's whole-sweep kernel ``ddpg_sweep_pallas`` in interpret mode and
against the XLA scan it replaces (``jax.grad`` + ``optax.adam``, as
``DDPGLearner.gradient_step`` runs it), on the same minibatches.

The contract is tests/test_ddpg_sweep_kernel.py's: after one step the Adam
moments (the gradients, seen through ``mu = (1 − b1)·g``) agree at rtol
1e-5 / atol 1e-8; after 8 steps at least 99.9 % of the parameters agree at
rtol 1e-4 / atol 3e-6 and every one lies within 8·lr, since Adam's update is
chaotic in f32 rounding where the gradient is near zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig
from smart_nanogrid_gym_tpu.ops.pallas_ddpg_sweep import DDPGSweepHypers as JaxHypers, ddpg_sweep_pallas
from smart_nanogrid_gym_tpu.solvers.networks import DDPGActor as FlaxDDPGActor, DDPGCritic as FlaxDDPGCritic

from smart_nanogrid_gym_torch.ops.ddpg_sweep import DDPGSweepHypers, ddpg_sweep, ddpg_sweep_plain
from smart_nanogrid_gym_torch.ops.ppo_sweep import zeros_adam
from smart_nanogrid_gym_torch.solvers.networks import mlp_leaves_from_flax
from smart_nanogrid_gym_torch.utils.weights import ddpg_state_to_jax

CFG = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
LR, GAMMA, TAU = 1e-3, 0.99, 5e-3
M = 64
HIDDEN = (128, 96)  # test width; the card's tests and chip_smoke run 400-300


def inputs(G, seed):
    """Flax actor and critic and G numpy minibatches of M samples."""
    F, A = CFG.obs_dim, CFG.num_actions
    low, high = CFG.action_bounds()
    actor = FlaxDDPGActor(A, tuple(low.tolist()), tuple(high.tolist()), HIDDEN)
    critic = FlaxDDPGCritic(HIDDEN)
    with jax.enable_x64(False):
        a_params = actor.init(jax.random.PRNGKey(seed), jnp.zeros((1, F), jnp.float32))
        c_params = critic.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, F), jnp.float32),
                               jnp.zeros((1, A), jnp.float32))
    rng = np.random.default_rng(seed)
    batches = (rng.normal(size=(G, M, F)).astype(np.float32),
               rng.uniform(low, high, size=(G, M, A)).astype(np.float32),
               (-10.0 * rng.random((G, M))).astype(np.float32),
               rng.normal(size=(G, M, F)).astype(np.float32),
               (rng.random((G, M)) < 0.1).astype(np.float32))
    return actor, critic, jax.tree.map(np.asarray, a_params), jax.tree.map(np.asarray, c_params), batches


def port_sweep(a_params, c_params, batches, impl=ddpg_sweep_plain, hp=None):
    a = mlp_leaves_from_flax(a_params, "mu")
    c = mlp_leaves_from_flax(c_params, "q")
    low, high = (torch.as_tensor(b) for b in CFG.action_bounds())
    out = impl(a, c, a, c, zeros_adam(a), zeros_adam(c), *(torch.from_numpy(x) for x in batches), low, high,
               hp or DDPGSweepHypers(lr=LR, gamma=GAMMA, tau=TAU))
    return ddpg_state_to_jax(*out[:6]), out[6].numpy()


def pallas_sweep(a_params, c_params, batches, hp=None):
    zeros = functools.partial(jax.tree.map, jnp.zeros_like)
    low, high = CFG.action_bounds()
    with jax.enable_x64(False):
        out = ddpg_sweep_pallas(a_params, c_params, a_params, c_params, 0, zeros(a_params), zeros(a_params),
                                0, zeros(c_params), zeros(c_params), *(jnp.asarray(x) for x in batches),
                                jnp.asarray(low), jnp.asarray(high), hp or JaxHypers(lr=LR, gamma=GAMMA, tau=TAU),
                                interpret=True)
    actor, critic, ta, tc, (a_count, a_mu, a_nu), (c_count, c_mu, c_nu), metrics = out
    return {"actor_params": actor, "critic_params": critic, "target_actor_params": ta,
            "target_critic_params": tc, "actor_opt": {"count": a_count, "mu": a_mu, "nu": a_nu},
            "critic_opt": {"count": c_count, "mu": c_mu, "nu": c_nu}}, np.asarray(metrics)


def xla_sweep(actor, critic, a_params, c_params, batches):
    """The XLA scan's gradient steps (ddpg.py:349-381) on the given minibatches."""
    tx = optax.adam(LR)

    @jax.jit
    def step(carry, batch):
        ap, cp, ta, tc, ao, co = carry
        obs, act, rew, nxt, done = batch
        target_q = rew + GAMMA * (1.0 - done) * critic.apply(tc, nxt, actor.apply(ta, nxt))
        c_loss, c_grads = jax.value_and_grad(
            lambda p: ((critic.apply(p, obs, act) - target_q) ** 2).mean())(cp)
        upd, co = tx.update(c_grads, co, cp)
        cp = optax.apply_updates(cp, upd)
        a_loss, a_grads = jax.value_and_grad(lambda p: -critic.apply(cp, obs, actor.apply(p, obs)).mean())(ap)
        upd, ao = tx.update(a_grads, ao, ap)
        ap = optax.apply_updates(ap, upd)
        polyak = functools.partial(jax.tree.map, lambda t, p: (1 - TAU) * t + TAU * p)
        return (ap, cp, polyak(ta, ap), polyak(tc, cp), ao, co), jnp.stack([c_loss, a_loss])

    with jax.enable_x64(False):
        carry = (a_params, c_params, a_params, c_params, tx.init(a_params), tx.init(c_params))
        rows = []
        for g in range(batches[0].shape[0]):
            carry, row = step(carry, tuple(jnp.asarray(x[g]) for x in batches))
            rows.append(row)
    ap, cp, ta, tc, ao, co = carry
    opt = lambda o: {"count": o[0].count, "mu": o[0].mu, "nu": o[0].nu}  # noqa: E731
    return {"actor_params": ap, "critic_params": cp, "target_actor_params": ta, "target_critic_params": tc,
            "actor_opt": opt(ao), "critic_opt": opt(co)}, np.stack(rows)


def assert_tree_close(got, want, rtol, atol, msg):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                                         rtol=rtol, atol=atol, err_msg=msg), got, want)


def assert_sweep_close(got, want, G, msg):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        close = np.isclose(g, w, rtol=1e-4, atol=3e-6)
        assert close.mean() > 0.999, (msg, 1 - close.mean())
        np.testing.assert_allclose(g, w, atol=G * LR, err_msg=msg)


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_one_step_gradients_match(reference):
    actor, critic, a_params, c_params, batches = inputs(1, 0)
    got, got_m = port_sweep(a_params, c_params, batches)
    if reference == "pallas":
        want, want_m = pallas_sweep(a_params, c_params, batches)
    else:
        want, want_m = xla_sweep(actor, critic, a_params, c_params, batches)
    for key in ("actor_opt", "critic_opt"):
        assert int(got[key]["count"]) == int(want[key]["count"]) == 1
        assert_tree_close(got[key]["mu"], want[key]["mu"], 1e-5, 1e-8, f"{key} mu")
        assert_tree_close(got[key]["nu"], want[key]["nu"], 1e-5, 1e-8, f"{key} nu")
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5, atol=1e-6)
    for key in ("actor_params", "critic_params", "target_actor_params", "target_critic_params"):
        assert_sweep_close(got[key], want[key], 1, key)


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_eight_step_sweep_matches(reference):
    actor, critic, a_params, c_params, batches = inputs(8, 1)
    got, got_m = port_sweep(a_params, c_params, batches)
    if reference == "pallas":
        want, want_m = pallas_sweep(a_params, c_params, batches)
    else:
        want, want_m = xla_sweep(actor, critic, a_params, c_params, batches)
    for key in ("actor_params", "critic_params", "target_actor_params", "target_critic_params"):
        assert_sweep_close(got[key], want[key], 8, key)
    assert int(got["actor_opt"]["count"]) == 8
    np.testing.assert_allclose(got_m, want_m, rtol=1e-3, atol=1e-5)


def test_sweep_wrapper_takes_the_twin_on_the_cpu_and_checks_shapes():
    _, _, a_params, c_params, batches = inputs(2, 2)
    got, got_m = port_sweep(a_params, c_params, batches, impl=ddpg_sweep)
    want, want_m = port_sweep(a_params, c_params, batches)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    np.testing.assert_array_equal(got_m, want_m)
    a = mlp_leaves_from_flax(a_params, "mu")
    c = mlp_leaves_from_flax(c_params, "q")
    obs, act, rew, nxt, done = (torch.from_numpy(x) for x in batches)
    hp = DDPGSweepHypers(LR, GAMMA, TAU)
    with pytest.raises(ValueError, match="b_next"):
        ddpg_sweep(a, c, a, c, zeros_adam(a), zeros_adam(c), obs, act, rew, nxt[:, :10], done,
                   torch.zeros(5), torch.ones(5), hp)
    with pytest.raises(ValueError, match="the data has"):
        ddpg_sweep(a, c, a, c, zeros_adam(a), zeros_adam(c), obs, act[:, :, :2], rew, nxt, done,
                   torch.zeros(2), torch.ones(2), hp)


def test_phase_profiler_instruments_the_current_kernel():
    """``tools/profile_k10_phases.py`` patches the K10 sources by text: every
    anchor it needs is there once, and its phase names follow the kernel's
    ``PhaseId`` order."""
    import re

    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.tools.profile_k10_phases import PHASES, instrument

    cuh, cu = ((_build.CSRC / name).read_text() for name in ("ddpg_sweep.cuh", "ddpg_sweep.cu"))
    timed, entry = instrument(cuh, cu)
    assert timed.count("= clock_ns();") == 3 and "ngk_phase_clock" in entry
    enum = cuh[cuh.index("enum PhaseId"):cuh.index("  kPhases,")]
    assert tuple(re.findall(r"^\s+k(\w+?)(?: = 0)?,", enum, re.M)) == PHASES
