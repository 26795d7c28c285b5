"""The PyTorch port's PPO learner (``solvers/ppo.py``) against the JAX
package's, one update on the same inputs.

- The plain learner (``collect_impl``/``sweep_impl="plain"``) against
  ``PPOLearner`` with ``collect_impl="xla"``: the port is fed JAX's own day
  uniforms, PV shifts, action normals and permutations, re-derived from the
  JAX state's key exactly as ``_shard_train_step`` splits it.  Parameters
  after the ``G``-step sweep agree at rtol 1e-4 (the sweep bar of
  tests/test_ppo_sweep_kernel.py).
- The same on a heterogeneous batch (G2: per-env masks, capacities, powers,
  price and PV), five more updates staying finite, the kernel path refusing it.
- The kernel path (K2's twin, GAE, K3's twin in the featlane layout) against
  the JAX composition ``pallas_ppo_collect_day`` + ``PPOLearner._gae`` +
  ``ppo_sweep_pallas_streamed(data_layout="featlane")`` fed K2's Philox draws
  and the port's block permutation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.ops.pallas_collect import pallas_ppo_collect_day
from smart_nanogrid_gym_tpu.ops.pallas_ppo_sweep import SweepHypers as JaxHypers, ppo_sweep_pallas_streamed
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig as JaxPPOConfig, PPOLearner as JaxPPOLearner

from smart_nanogrid_gym_torch.core.params import NanogridParams, make_params
from smart_nanogrid_gym_torch.ops import launch_counts, reset_launch_counts
from smart_nanogrid_gym_torch.ops.gen_rollout import pv_shift_from_uniform
from smart_nanogrid_gym_torch.ops.philox import collect_draws
from smart_nanogrid_gym_torch.parallel import EnvMesh
from smart_nanogrid_gym_torch.solvers.networks import ActorCritic, actor_critic_leaves
from smart_nanogrid_gym_torch.solvers.ppo import PlainDraws, PPOConfig, PPOLearner
from smart_nanogrid_gym_torch.utils.weights import leaves_to_flax, ppo_state_from_jax, ppo_state_to_jax

CFG = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)


def assert_tree_close(got, want, rtol, atol, msg):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                                         err_msg=msg), got, want)


def jax_update_draws(state, config, batch, epochs, perm_len):
    """The draws inside one JAX ``_shard_train_step`` (collect_impl="xla"),
    re-derived from ``state.key``: per-env day uniforms (generate_schedule)
    and PV shifts (reset), per-step action normals, per-epoch permutations."""
    T, N, A = config.steps_per_day, config.num_chargers, config.num_actions
    _, sub = jax.random.split(state.key)
    k_roll, k_perm = jax.random.split(sub)
    _, k_day, k_steps = jax.random.split(k_roll, 3)

    def per_env(key):
        k_sched, k_shift, _ = jax.random.split(key, 3)
        u = jax.random.uniform(k_sched, (T, 5, N), jnp.float32)
        return u, jax.random.randint(k_shift, (), 0, 181).astype(jnp.float32) / 100.0

    u, pv = jax.vmap(per_env)(jax.random.split(k_day, batch))
    normals = jnp.stack([jax.random.normal(k, (batch, A), jnp.float32) for k in jax.random.split(k_steps, T)])
    perms = jnp.stack([jax.random.permutation(k, perm_len) for k in jax.random.split(k_perm, epochs)])
    return PlainDraws([tuple(torch.from_numpy(np.array(x)) for x in (u, pv, normals))],
                      torch.from_numpy(np.array(perms)).long())


def port_state(learner, jax_state, params):
    leaves, adam = ppo_state_from_jax(jax.tree.map(np.asarray, jax_state.params),
                                      jax.tree.map(np.asarray, jax_state.opt_state))
    batt = torch.from_numpy(np.asarray(jax_state.env_states.batt_soc))
    return learner.state_from(leaves, adam, batt, torch.Generator().manual_seed(0), params)


@pytest.mark.parametrize("scheme", ["env", "block"])
def test_plain_learner_update_matches_jax_xla_learner(scheme):
    B, E, num_mb = 16, 2, 2
    kw = dict(num_epochs=E, num_minibatches=num_mb, minibatch_scheme=scheme)
    with jax.enable_x64(False):
        jl = JaxPPOLearner(CFG, JaxPPOConfig(**kw))
        jstate = jl.init(jax.random.PRNGKey(0), jax_make_params(CFG, dtype=jnp.float32), batch_size=B)
        jnew, jmet = jl.build_train_step()(jstate, jl.nanogrid_params_batched)
        M = (B // num_mb) * CFG.steps_per_day
        perm_len = B if scheme == "env" else (B * CFG.steps_per_day) // jl._block_granule(M)
        draws = jax_update_draws(jstate, CFG, B, E, perm_len)

    learner = PPOLearner(CFG, PPOConfig(**kw), device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    new, met = learner.build_train_step()(port_state(learner, jstate, params), params, draws)
    got_params, got_opt = ppo_state_to_jax(new.params, new.opt_state)
    assert_tree_close(got_params, jnew.params, 1e-4, 1e-6, "params")
    assert got_opt["count"] == int(jax.tree.leaves(jnew.opt_state)[0]) == E * num_mb
    np.testing.assert_allclose(float(met.mean_return), float(jmet.mean_return), rtol=1e-5)
    np.testing.assert_allclose(new.batt_soc.numpy(), np.asarray(jnew.env_states.batt_soc), rtol=1e-5, atol=1e-6)
    for name in ("policy_loss", "value_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(float(getattr(met, name)), float(getattr(jmet, name)), rtol=1e-3, atol=1e-6,
                                   err_msg=name)


def heterogeneous_params(jax_batched, B):
    """tests/test_heterogeneous_compile.py:74-85's batch: per-env charger
    masks (column 0 set), BESS capacities, charger powers, and price and PV
    tables scaled per env; returned for JAX and as the port's params."""
    rng = np.random.RandomState(1)
    masks = (rng.rand(B, 4) > 0.3).astype(np.float32)
    masks[:, 0] = 1.0
    het = jax_batched._replace(
        charger_mask=jnp.asarray(masks),
        batt_capacity=jnp.asarray(rng.uniform(40, 160, B), jnp.float32),
        charger_max_power=jnp.asarray(rng.uniform(11, 44, B), jnp.float32),
        price=jax_batched.price * jnp.asarray(rng.uniform(0.5, 2.0, (B, 1)), jnp.float32),
        solar_power=jax_batched.solar_power * jnp.asarray(rng.uniform(0.2, 3.0, (B, 1)), jnp.float32),
    )
    port = NanogridParams(**{name: torch.from_numpy(np.array(getattr(het, name))) for name in NanogridParams._fields})
    return het, port


def test_plain_learner_heterogeneous_update_matches_jax_xla_learner():
    """G2: one plain update over a batch whose every env has its own params
    against the JAX XLA learner (same draws, the tolerance of the
    homogeneous test), five more staying finite, and the kernel path
    refusing the batch through the param guard."""
    B, E, num_mb = 32, 2, 2
    kw = dict(num_epochs=E, num_minibatches=num_mb)
    with jax.enable_x64(False):
        jl = JaxPPOLearner(CFG, JaxPPOConfig(**kw))
        jstate = jl.init(jax.random.PRNGKey(0), jax_make_params(CFG, dtype=jnp.float32), batch_size=B)
        het, params = heterogeneous_params(jl.nanogrid_params_batched, B)
        jnew, jmet = jl.build_train_step()(jstate, het)
        draws = jax_update_draws(jstate, CFG, B, E, B)
    assert params.batched and params.dtype == torch.float32

    learner = PPOLearner(CFG, PPOConfig(**kw), device="cpu")
    step = learner.build_train_step()
    new, met = step(port_state(learner, jstate, params), params, draws)
    got_params, _ = ppo_state_to_jax(new.params, new.opt_state)
    assert_tree_close(got_params, jnew.params, 1e-4, 1e-6, "params")
    np.testing.assert_allclose(float(met.mean_return), float(jmet.mean_return), rtol=1e-5)
    np.testing.assert_allclose(new.batt_soc.numpy(), np.asarray(jnew.env_states.batt_soc), rtol=1e-5, atol=1e-6)
    for name in ("policy_loss", "value_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(float(getattr(met, name)), float(getattr(jmet, name)), rtol=1e-3, atol=1e-6,
                                   err_msg=name)

    returns = []
    for _ in range(5):
        new, met = step(new, params)
        returns.append(float(met.mean_return))
    assert np.isfinite(returns).all() and np.isfinite(float(met.policy_loss)), returns
    assert all(bool(torch.isfinite(x).all()) for x in new.params)

    kernel = PPOLearner(CFG, PPOConfig(collect_impl="kernel", sweep_impl="kernel"), device="cpu")
    with pytest.raises(ValueError, match="bakes params.charger_max_power"):
        kernel.build_train_step()(kernel.init(0, params, 128), params)


def test_kernel_path_update_matches_jax_kernel_composition():
    B = 128
    learner = PPOLearner(CFG, PPOConfig(num_epochs=1, num_minibatches=4, collect_impl="kernel",
                                        sweep_impl="kernel"), device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    state = learner.init(3, params, B)
    state = state._replace(batt_soc=torch.linspace(0.05, 0.95, B))
    replay = torch.Generator()
    replay.set_state(state.generator.get_state())
    num_mb, slab, n_bl = learner.kernel_layout(B)
    seed, perms = learner.draw_kernel(replay, n_bl)
    new, met = learner.build_train_step()(state, params)

    T, N, A = CFG.steps_per_day, CFG.num_chargers, CFG.num_actions
    u, normals, u_pv = collect_draws(seed, B, T, N, A, "cpu")
    flax_params = leaves_to_flax(state.params)
    with jax.enable_x64(False):
        jparams = jax_make_params(CFG, dtype=jnp.float32)
        obs, act, logp, val, rew, batt = pallas_ppo_collect_day(
            CFG, jparams, flax_params, *(jnp.asarray(x.numpy()) for x in
                                         (u, normals, pv_shift_from_uniform(u_pv), state.batt_soc)),
            interpret=True)
        jl = JaxPPOLearner(CFG)
        dones = jnp.zeros((T, B), bool).at[-1].set(True)
        adv, ret = jl._gae(rew, val, dones, jnp.zeros((B,), jnp.float32))
        zeros = jax.tree.map(jnp.zeros_like, flax_params)
        hp = JaxHypers(lr=3e-4, clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, max_grad_norm=0.5)
        jp, count, _, nu, met_g = ppo_sweep_pallas_streamed(
            flax_params, jnp.int32(0), zeros, zeros, obs, act, logp, adv, ret,
            jnp.asarray(perms.reshape(num_mb, n_bl // num_mb).numpy(), jnp.int32), slab, hp,
            interpret=True, data_layout="featlane")

    got_params, got_opt = ppo_state_to_jax(new.params, new.opt_state)
    assert got_opt["count"] == int(count) == num_mb
    assert_tree_close(got_params, jp, 1e-4, 1e-6, "params")
    np.testing.assert_allclose(new.batt_soc.numpy(), np.asarray(batt), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(met.mean_return), float(rew.sum(axis=0).mean()), rtol=1e-5)
    np.testing.assert_allclose(float(met.approx_kl), float(met_g[:, 3].mean()), rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("seed, T, B", [(0, 24, 37), (1, 1, 5), (2, 48, 128), (3, 24, 1)])
def test_gae_twin_matches_jax_learner_gae(seed, T, B):
    """The learner's GAE on the CPU (``ops/gae.py``'s eager twin, no launch)
    against the JAX learner's ``_gae`` (a ``lax.scan``) in f32, on random
    dones and a nonzero bootstrap value: XLA's CPU loop rounds some steps
    otherwise (one or two f32 ulps of the advantages, about 5e-7), so the
    bar adds an absolute 1e-6 to rtol 1e-6."""
    rng = np.random.default_rng(seed)
    rewards, values = rng.normal(size=(2, T, B)).astype(np.float32)
    dones, last_value = rng.random((T, B)) < 0.2, rng.normal(size=B).astype(np.float32)
    reset_launch_counts()
    adv, ret = PPOLearner(CFG, device="cpu")._gae(*map(torch.from_numpy, (rewards, values, dones, last_value)))
    assert not launch_counts
    with jax.enable_x64(False):
        jadv, jret = JaxPPOLearner(CFG)._gae(*map(jnp.asarray, (rewards, values, dones, last_value)))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-6, atol=1e-6)


def test_kernel_path_builds_its_day_end_once():
    """The kernel path hands GAE the day-end dones (only t = T-1 set) and the
    zero bootstrap values it built at its first update, the same tensors at
    every later update."""
    B = 32
    learner = PPOLearner(CFG, PPOConfig(num_epochs=1, num_minibatches=2, collect_impl="kernel",
                                        sweep_impl="kernel"), device="cpu")
    params = make_params(CFG, torch.float32, "cpu")
    seen = []
    gae_of = learner._gae
    learner._gae = lambda rewards, values, dones, last_value: seen.append((dones, last_value)) or gae_of(
        rewards, values, dones, last_value)
    step = learner.build_train_step()
    state = learner.init(0, params, B)
    for _ in range(2):
        state, _ = step(state, params)
    (dones, last_value), again = seen
    assert again[0] is dones and again[1] is last_value
    T = CFG.steps_per_day
    assert dones.shape == (T, B) and bool(dones[-1].all()) and not bool(dones[:-1].any())
    assert torch.equal(last_value, torch.zeros(B))


def test_orthogonal_init_has_the_flax_gains():
    """Every kernel of a fresh ActorCritic has singular values equal to its
    gain, as flax's orthogonal initialiser gives them (√2 hidden, 0.01 pi
    output, 1.0 vf output); biases and log_std start at zero."""
    config = NanogridConfig(num_chargers=8)
    net = ActorCritic(config.obs_dim, config.num_actions, generator=torch.Generator().manual_seed(0))
    with jax.enable_x64(False):
        flax_params = FlaxActorCritic(action_dim=config.num_actions).init(
            jax.random.PRNGKey(0), jnp.zeros((1, config.obs_dim), jnp.float32))["params"]
    gains = [np.sqrt(2.0), np.sqrt(2.0), 0.01]
    leaves = actor_critic_leaves(net)
    for n, name in enumerate(("pi", "vf")):
        for i in range(3):
            gain = gains[i] if (name == "pi" or i < 2) else 1.0
            w = leaves[6 * n + 2 * i].detach().double().numpy()
            ref = np.asarray(flax_params[name][f"Dense_{i}"]["kernel"], np.float64)
            np.testing.assert_allclose(np.linalg.svd(w, compute_uv=False), gain, rtol=1e-5)
            np.testing.assert_allclose(np.linalg.svd(ref, compute_uv=False), gain, rtol=1e-5)
            assert w.shape == ref.T.shape
            assert not leaves[6 * n + 2 * i + 1].detach().any()
    assert not net.log_std.detach().any()
    same = ActorCritic(config.obs_dim, config.num_actions, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(actor_critic_leaves(net), actor_critic_leaves(same)))


def test_ppo_state_round_trip_through_jax_layout():
    with jax.enable_x64(False):
        jl = JaxPPOLearner(CFG)
        jstate = jl.init(jax.random.PRNGKey(1), jax_make_params(CFG, dtype=jnp.float32), batch_size=4)
    params_np = jax.tree.map(np.asarray, jstate.params)
    leaves, adam = ppo_state_from_jax(params_np, jax.tree.map(np.asarray, jstate.opt_state))
    back, opt = ppo_state_to_jax(leaves, adam)
    jax.tree.map(np.testing.assert_array_equal, back, params_np)
    assert opt["count"] == 0 and all(not x.any() for x in jax.tree.leaves(opt["mu"]))


def test_kernel_path_rejects_what_the_jax_package_rejects():
    params = make_params(CFG, torch.float32, "cpu")
    learner = PPOLearner(CFG, PPOConfig(collect_impl="kernel", sweep_impl="plain"), device="cpu")
    with pytest.raises(ValueError, match="sweep_impl='kernel'"):
        learner.build_train_step()(learner.init(0, params, 8), params)
    learner = PPOLearner(CFG, PPOConfig(num_minibatches=5, collect_impl="kernel", sweep_impl="kernel"),
                         device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        learner.build_train_step()(learner.init(0, params, 128), params)
    for impl in ("plain", "kernel"):  # the bf16 sweep option is accepted on both paths
        bf16 = PPOLearner(CFG, PPOConfig(update_matmul_dtype=torch.bfloat16, sweep_impl=impl), device="cpu")
        assert bf16._hypers().matmul_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="operand dtype"):
        PPOLearner(CFG, PPOConfig(update_matmul_dtype=torch.float16), device="cpu")
    with pytest.raises(TypeError, match="EnvMesh"):
        PPOLearner(CFG, mesh=object(), device="cpu")
    two_ranks = EnvMesh(None, 0, 2, torch.device("cpu"))  # K3 applies Adam locally
    for kw, field in (({"sweep_impl": "kernel"}, "sweep_impl"),
                      ({"collect_impl": "kernel", "sweep_impl": "kernel"}, "sweep_impl"),
                      ({"collect_impl": "kernel"}, "collect_impl")):
        with pytest.raises(ValueError, match=f"{field}='kernel' supports world size 1 only"):
            PPOLearner(CFG, PPOConfig(**kw), mesh=two_ranks)
    with pytest.raises(ValueError, match="requires a mesh"):
        PPOLearner(CFG, device="cpu").init_distributed(0, params, 8)


def test_train_improves_the_mean_return_on_the_kernel_path():
    """A few kernel-path updates (the twins, on the CPU) raise the mean day
    return from the first update's, as the chip smoke checks at full width."""
    params = make_params(CFG, torch.float32, "cpu")
    learner = PPOLearner(CFG, PPOConfig(num_epochs=4, num_minibatches=4, collect_impl="kernel",
                                        sweep_impl="kernel"), device="cpu")
    state = learner.init(0, params, 128)
    state, history = learner.train(state, 12, log_every=1)
    first = history[0].mean_return
    last = np.mean([h.mean_return for h in history[-3:]])
    assert np.isfinite(last) and last > first, (first, last)
    many = learner.build_train_many(2)
    state, stacked = many(state, params)
    assert stacked.mean_return.shape == (2,) and state.update_step == 14
