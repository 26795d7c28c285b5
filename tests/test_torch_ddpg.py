"""The PyTorch port's DDPG learner (``solvers/ddpg.py``) against the JAX
package's, one update on the same inputs, and its buffer, noise and
collection paths.

The port is fed JAX's own draws, re-derived from the JAX state's key exactly
as ``DDPGLearner._train_body`` and ``_collect`` split it: the per-env day
uniforms and PV shifts of the reset, the OU gaussians and every gradient
step's ``(t_idx, b_idx)``.  Two port paths are held against
``_train_body(sweep_impl="xla")``: the plain collection with the plain
(autograd) sweep, and with K10's twin.  Parameters after the ``G``-step sweep
meet tests/test_ddpg_sweep_kernel.py's sweep contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig as JaxDDPGConfig, DDPGLearner as JaxDDPGLearner

from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops.ddpg_collect import ddpg_collect_day_seeded
from smart_nanogrid_gym_torch.parallel import EnvMesh
from smart_nanogrid_gym_torch.solvers.ddpg import DDPGConfig, DDPGDraws, DDPGLearner, ReplayBuffer, ou_step
from smart_nanogrid_gym_torch.utils.weights import ddpg_state_from_jax, ddpg_state_to_jax

CFG = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
B, M, G, LR = 16, 64, 4, 1e-3


def jax_update_draws(state, config, cfg: JaxDDPGConfig, batch):
    """The draws inside one JAX ``_train_body`` with the fused collection."""
    T, N, A = config.steps_per_day, config.num_chargers, config.num_actions
    _, k_collect, k_grad = jax.random.split(state.key, 3)
    key, k_day = jax.random.split(k_collect)

    def per_env(k):
        k_sched, k_shift, _ = jax.random.split(k, 3)
        u = jax.random.uniform(k_sched, (T, 5, N), jnp.float32)
        return u, jax.random.randint(k_shift, (), 0, 181).astype(jnp.float32) / 100.0

    u, pv = jax.vmap(per_env)(jax.random.split(k_day, batch))
    _, k_noise, _ = jax.random.split(key, 3)
    gaussians = jax.random.normal(k_noise, (T, batch, A), jnp.float32)
    filled = min(int(state.buffer.filled) + T, state.buffer.obs.shape[0])

    def draw(kg):
        k1, k2 = jax.random.split(kg)
        return (jax.random.randint(k1, (cfg.batch_size,), 0, max(filled, 1)),
                jax.random.randint(k2, (cfg.batch_size,), 0, batch))

    t_idx, b_idx = jax.vmap(draw)(jax.random.split(k_grad, cfg.gradient_steps))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return DDPGDraws(t(gaussians), t(t_idx).long(), t(b_idx).long(), t(u), t(pv))


def port_state(learner, jax_state, params):
    trees = jax.tree.map(np.asarray, jax_state)._asdict()
    batt = torch.from_numpy(np.array(jax_state.env_states.batt_soc))
    return learner.state_from(*ddpg_state_from_jax(trees), batt, torch.Generator().manual_seed(0), params)


def assert_sweep_close(got, want, msg):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        close = np.isclose(g, w, rtol=1e-4, atol=3e-6)
        assert close.mean() > 0.999, (msg, 1 - close.mean())
        np.testing.assert_allclose(g, w, atol=G * LR, err_msg=msg)


@pytest.mark.parametrize("sweep_impl", ["plain", "kernel"])
def test_learner_update_matches_jax_train_body(sweep_impl):
    kw = dict(buffer_days=2, batch_size=M, gradient_steps=G)
    with jax.enable_x64(False):
        jl = JaxDDPGLearner(CFG, JaxDDPGConfig(**kw))
        jstate = jl.init(jax.random.PRNGKey(0), jax_make_params(CFG, dtype=jnp.float32), batch_size=B)
        jnew, jmet = jl._train_body(jstate, jl.nanogrid_params_batched)
        draws = jax_update_draws(jstate, CFG, jl.cfg, B)
    learner = DDPGLearner(CFG, DDPGConfig(**kw, sweep_impl=sweep_impl), device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    new, met = learner.build_train_step()(port_state(learner, jstate, params), params, draws)

    got = ddpg_state_to_jax(new.actor, new.critic, new.target_actor, new.target_critic, new.actor_opt,
                            new.critic_opt)
    for key in ("actor_params", "critic_params", "target_actor_params", "target_critic_params"):
        assert_sweep_close(got[key], getattr(jnew, key), key)
    assert got["actor_opt"]["count"] == got["critic_opt"]["count"] == G
    for name in ("obs", "actions", "rewards", "next_obs"):
        np.testing.assert_allclose(getattr(new.buffer, name).numpy(), np.asarray(getattr(jnew.buffer, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(new.buffer.dones.numpy(), np.asarray(jnew.buffer.dones))
    assert (new.buffer.insert_pos, new.buffer.filled) == (int(jnew.buffer.insert_pos), int(jnew.buffer.filled))
    np.testing.assert_allclose(new.batt_soc.numpy(), np.asarray(jnew.env_states.batt_soc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.last_obs.numpy(), np.asarray(jnew.last_obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.ou_state.numpy(), np.asarray(jnew.ou_state), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(met.mean_return), float(jmet["mean_return"]), rtol=1e-5)
    for name in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(float(getattr(met, name)), float(jmet[name]), rtol=1e-3, err_msg=name)


def test_kernel_path_update_writes_k9s_day_and_runs_k10():
    """The kernel path (K9 seeded's twin + K10's twin on the CPU) writes the
    collected day K9 gives for the update's seed and OU draws."""
    learner = DDPGLearner(CFG, DDPGConfig(buffer_days=2, batch_size=32, gradient_steps=2, collect_impl="kernel",
                                          sweep_impl="kernel"), device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    state = learner.init(3, params, 32)
    replay = torch.Generator()
    replay.set_state(state.generator.get_state())
    draws = learner.draw(replay, 32, CFG.steps_per_day)
    new, met = learner.build_train_step()(state, params)
    ou = learner._ou_sequence(draws.gaussians)
    obs, act, rew, nxt, batt = ddpg_collect_day_seeded(CFG, params, state.actor, draws.seed, ou, state.batt_soc, 32)
    torch.testing.assert_close(new.buffer.obs[:24], obs.permute(0, 2, 1), rtol=0, atol=0)
    torch.testing.assert_close(new.buffer.actions[:24], act.permute(0, 2, 1), rtol=0, atol=0)
    torch.testing.assert_close(new.buffer.next_obs[:24], nxt.permute(0, 2, 1), rtol=0, atol=0)
    torch.testing.assert_close(new.batt_soc, batt, rtol=0, atol=0)
    assert bool(new.buffer.dones[23].all()) and not bool(new.buffer.dones[:23].any())
    assert float(met.mean_return) == pytest.approx(float(rew.sum(0).mean()))
    assert new.actor_opt.count == 2 and torch.isfinite(met.critic_loss)


def test_ou_noise_matches_sb3_formula():
    theta, sigma, dt, mu = 0.15, 0.5, 1e-2, 0.0
    rng = np.random.RandomState(0)
    x_ref = np.zeros(5)
    x = torch.zeros(5, dtype=torch.float64)
    for _ in range(50):
        gauss = rng.normal(size=5)
        x_ref = x_ref + theta * (mu - x_ref) * dt + sigma * np.sqrt(dt) * gauss
        x = ou_step(x, torch.from_numpy(gauss), theta, sigma, dt, mu)
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-12)
    assert np.abs(x_ref).max() < sigma * 10


def test_fused_collect_matches_sequential():
    learner = DDPGLearner(CFG, DDPGConfig(buffer_days=2, gradient_steps=2, batch_size=32), device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    state = learner.init(7, params, 8)
    draws = learner.draw(torch.Generator().manual_seed(11), 8, 24)
    fused = learner._collect(state, params, draws)
    learner._force_sequential_collect = True
    seq = learner._collect(state._replace(buffer=learner.empty_buffer(8)), params, draws)
    for name, a, b in zip(("batt", "obs", "ou", "buffer", "rewards"), fused, seq):
        for x, y in zip(a if name == "buffer" else (a,), b if name == "buffer" else (b,)):
            np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_insert_day_rejects_misaligned_capacity():
    buf = ReplayBuffer(torch.zeros((30, 4, 3)), torch.zeros((30, 4, 2)), torch.zeros((30, 4)),
                       torch.zeros((30, 4, 3)), torch.zeros((30, 4), dtype=torch.bool), 0, 0)
    day = (torch.zeros((24, 4, 3)), torch.zeros((24, 4, 2)), torch.zeros((24, 4)), torch.zeros((24, 4, 3)),
           torch.zeros((24, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of the day block"):
        DDPGLearner._insert_day(buf, *day)


def test_buffer_wraps_around_in_whole_days():
    """With a 2-day buffer the 3rd collected day overwrites day 0 in place."""
    learner = DDPGLearner(CFG, DDPGConfig(buffer_days=2, gradient_steps=2, batch_size=32), device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    state = learner.init(5, params, 8)
    days = []
    for _ in range(3):
        state, _ = learner.build_train_step()(state, params)
        days.append(state.buffer.rewards[24:].clone() if len(days) == 1 else state.buffer.rewards[:24].clone())
    C = 2 * CFG.steps_per_day
    assert state.buffer.filled == C and state.buffer.insert_pos == (3 * CFG.steps_per_day) % C
    assert torch.equal(state.buffer.rewards[24:], days[1]) and torch.equal(state.buffer.rewards[:24], days[2])
    assert not torch.equal(days[0], days[2]) and bool(torch.isfinite(state.buffer.rewards).all())


def test_partial_day_collect_fallback():
    learner = DDPGLearner(CFG, DDPGConfig(buffer_days=2, gradient_steps=2, batch_size=32, steps_per_update=12),
                          device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    state = learner.init(4, params, 8)
    state, history = learner.train(state, 2, log_every=1)
    assert state.buffer.filled == 2 * 12 and state.buffer.insert_pos == 2 * 12
    assert not bool(state.buffer.dones.any())
    for m in history:
        assert all(np.isfinite(v) for v in m), m


def test_learner_rejects_what_is_not_ported_or_not_a_whole_day():
    params = make_params(CFG, torch.float32, "cpu")
    for impl in ("plain", "kernel"):  # the bf16 sweep option is accepted (the plain sweep ignores it)
        bf16 = DDPGLearner(CFG, DDPGConfig(update_matmul_dtype=torch.bfloat16, sweep_impl=impl), device="cpu")
        assert bf16._hypers().matmul_dtype == torch.bfloat16
    with pytest.raises(TypeError, match="EnvMesh"):
        DDPGLearner(CFG, mesh=object(), device="cpu")
    two_ranks = EnvMesh(None, 0, 2, torch.device("cpu"))  # the kernel paths apply Adam locally
    for kw, field in (({"sweep_impl": "kernel"}, "sweep_impl"), ({"collect_impl": "kernel"}, "collect_impl")):
        with pytest.raises(ValueError, match=f"{field}='kernel' supports world size 1 only"):
            DDPGLearner(CFG, DDPGConfig(**kw), mesh=two_ranks)
    one_rank = DDPGLearner(CFG, DDPGConfig(collect_impl="kernel", sweep_impl="kernel"),
                           mesh=EnvMesh(None, 0, 1, torch.device("cpu")))
    assert one_rank.device == torch.device("cpu")
    with pytest.raises(ValueError, match="sweep_impl"):
        DDPGLearner(CFG, DDPGConfig(sweep_impl="pallas"), device="cpu")
    learner = DDPGLearner(CFG, DDPGConfig(steps_per_update=12, collect_impl="kernel"), device="cpu")
    with pytest.raises(ValueError, match="whole days"):
        learner.build_train_step()(learner.init(0, params, 8), params)


def test_training_fits_the_critic():
    """A few updates fit the critic: its TD error on replayed transitions
    drops below the initial critic's, and every metric stays finite.
    Beating the initial actor on env returns takes on the order of a
    hundred updates at 4 chargers (the JAX package's own test runs 200),
    more than a CPU test can afford; the chip smoke checks it at B=4096."""
    from smart_nanogrid_gym_torch.solvers.ddpg import actor_apply, critic_apply

    params = make_params(CFG, torch.float32, "cpu")
    learner = DDPGLearner(CFG, DDPGConfig(batch_size=64, buffer_days=4, gradient_steps=8), device="cpu")
    state0 = learner.init(0, params, 32)
    state, history = learner.build_train_many(12)(state0, params)
    assert state.update_step == 12 and history.mean_return.shape == (12,)
    assert bool(torch.isfinite(torch.stack(history)).all())
    low, high = learner._action_low, learner._action_high
    gen = torch.Generator().manual_seed(0)
    obs, act, rew, nxt, done = learner._sample(state.buffer, torch.randint(0, state.buffer.filled, (1024,),
                                                                           generator=gen),
                                               torch.randint(0, 32, (1024,), generator=gen))

    def td_error(s):
        with torch.no_grad():
            target = rew + 0.99 * (1.0 - done) * critic_apply(s.target_critic, nxt,
                                                              actor_apply(s.target_actor, nxt, low, high))
            return float(((critic_apply(s.critic, obs, act) - target) ** 2).mean())

    assert td_error(state) < 0.75 * td_error(state0), (td_error(state), td_error(state0))
