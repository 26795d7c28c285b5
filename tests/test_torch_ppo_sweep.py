"""The update sweep's twin (K3/K4, ``ops/ppo_sweep.py``) of the PyTorch port,
with the JAX package as the reference.

The twin computes the JAX kernel's hand-written backward with matrix
products, in another summation order, so parameters agree to f32 reduction
rounding: one gradient step at rtol 1e-5, a sweep of G steps at rtol 1e-4
(the bars of tests/test_ppo_sweep_kernel.py).  The port normalises a
minibatch's advantages with a centred std; in the ``|mean| ≫ std`` regime it
is held against the JAX reference loss ``PPOLearner._loss`` (jax.grad +
optax), not against the JAX kernel's ``E[x²] − mean²``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig
from smart_nanogrid_gym_tpu.ops.pallas_ppo_sweep import (
    SweepHypers as JaxHypers,
    _flatten_actor_critic,
    _pick_chunk,
    ppo_sweep_pallas,
    ppo_sweep_pallas_streamed,
)
from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic
from smart_nanogrid_gym_tpu.solvers.ppo import PPOLearner as JaxPPOLearner

from smart_nanogrid_gym_torch.ops.ppo_sweep import (
    GRAD_TILE,
    MAX_GRAD_BLOCKS,
    NORM_SLICES,
    SweepHypers,
    _adam_block_norm,
    _kernel_order_sum,
    flatten_leaves,
    grad_step_plain,
    minibatch_stats,
    pick_chunk,
    ppo_sweep,
    ppo_sweep_streamed,
    zeros_adam,
)
from smart_nanogrid_gym_torch.utils.weights import leaves_from_flax, leaves_to_flax

F, A = 25, 9
HP = dict(lr=3e-4, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, max_grad_norm=0.5)


def flax_net(seed):
    with jax.enable_x64(False):
        params = FlaxActorCritic(action_dim=A).init(jax.random.PRNGKey(seed), jnp.zeros((1, F), jnp.float32))
    return jax.tree.map(np.asarray, params)


def assert_tree_close(got_leaves, want_tree, rtol, atol, msg):
    got = leaves_to_flax(got_leaves)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol, err_msg=msg),
                 got, jax.tree.map(np.asarray, want_tree))


def sweep_data(seed, shape, adv_mean=0.0, adv_std=1.0):
    """obs/act/logp/adv/ret with logp near the policy's so that ratios
    straddle the clip region."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal(shape + (F,)).astype(np.float32)
    act = (0.5 * rng.standard_normal(shape + (A,))).astype(np.float32)
    logp = (-8.5 + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    adv = (adv_mean + adv_std * rng.standard_normal(shape)).astype(np.float32)
    ret = rng.standard_normal(shape).astype(np.float32)
    return obs, act, logp, adv, ret


def normalise(adv_g):
    mean = adv_g.mean(axis=1, keepdims=True)
    return ((adv_g - mean) / (np.sqrt(((adv_g - mean) ** 2).mean(axis=1, keepdims=True)) + 1e-8)).astype(np.float32)


@pytest.mark.parametrize("G,rtol", [(1, 1e-5), (4, 1e-4)])
def test_k4_twin_matches_pallas_sweep(G, rtol):
    flax_params = flax_net(1)
    M = 96
    obs, act, logp, adv, ret = sweep_data(2, (G, M))
    nadv = normalise(adv)
    with jax.enable_x64(False):
        zeros = jax.tree.map(jnp.zeros_like, flax_params)
        p, count, mu, nu, met = ppo_sweep_pallas(
            flax_params, jnp.int32(3), zeros, zeros, *(jnp.asarray(x) for x in (obs, act, logp, nadv, ret)),
            JaxHypers(**HP), interpret=True)
    leaves = leaves_from_flax(flax_params)
    adam = zeros_adam(leaves)._replace(count=3)
    got_p, got_adam, got_met = ppo_sweep(leaves, adam, *(torch.from_numpy(x) for x in (obs, act, logp, nadv, ret)),
                                         SweepHypers(**HP))
    assert got_adam.count == int(count) == 3 + G
    assert_tree_close(got_p, p, rtol, 1e-7 if G == 1 else 1e-6, "params")
    assert_tree_close(got_adam.mu, mu, rtol, 1e-8, "mu")
    assert_tree_close(got_adam.nu, nu, rtol, 1e-12, "nu")
    np.testing.assert_allclose(got_met.numpy(), np.asarray(met), rtol=1e-5, atol=1e-6, err_msg="metrics")


@pytest.mark.parametrize("G,rtol", [(1, 1e-5), (4, 1e-4)])
@pytest.mark.parametrize("layout", ["featlane", "sample"])
def test_k3_twin_matches_pallas_streamed(layout, G, rtol):
    flax_params = flax_net(4)
    granule, K = 32, 3
    if layout == "featlane":
        T, B = 6, 64
        obs, act, logp, adv, ret = sweep_data(5, (T, B))
        obs, act = obs.transpose(0, 2, 1).copy(), act.transpose(0, 2, 1).copy()
        n_bl = T * (B // granule)
    else:
        n_bl = 12
        obs, act, logp, adv, ret = sweep_data(5, (n_bl * granule,))
    rng = np.random.default_rng(6)
    block_perm = np.stack([rng.permutation(n_bl)[:K] for _ in range(G)]).astype(np.int32)
    with jax.enable_x64(False):
        zeros = jax.tree.map(jnp.zeros_like, flax_params)
        p, count, mu, nu, met = ppo_sweep_pallas_streamed(
            flax_params, jnp.int32(0), zeros, zeros, *(jnp.asarray(x) for x in (obs, act, logp, adv, ret)),
            jnp.asarray(block_perm), granule, JaxHypers(**HP), interpret=True, data_layout=layout)
    leaves = leaves_from_flax(flax_params)
    got_p, got_adam, got_met = ppo_sweep_streamed(
        leaves, zeros_adam(leaves), *(torch.from_numpy(x) for x in (obs, act, logp, adv, ret)),
        torch.from_numpy(block_perm), granule, SweepHypers(**HP), data_layout=layout)
    assert got_adam.count == int(count) == G
    assert_tree_close(got_p, p, rtol, 1e-7 if G == 1 else 1e-6, "params")
    assert_tree_close(got_adam.nu, nu, rtol, 1e-12, "nu")
    np.testing.assert_allclose(got_met.numpy(), np.asarray(met), rtol=1e-4, atol=1e-5, err_msg="metrics")


def test_centred_stats_match_reference_loss_when_mean_dominates():
    """Advantages 50 ± 0.5: the port's centred minibatch std is right to 1e-5
    of its float64 value, and the twin's gradient with those stats equals
    ``jax.grad`` of the JAX reference loss ``PPOLearner._loss`` (which
    normalises with ``jnp.std``) to rtol 1e-4."""
    flax_params = flax_net(7)
    S, granule = 128, 32
    obs, act, logp, adv, ret = sweep_data(8, (S,), adv_mean=50.0, adv_std=0.5)
    block_perm = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)
    order = block_perm.numpy()[0]
    take = lambda x: x.reshape((4, granule) + x.shape[1:])[order].reshape((S,) + x.shape[1:])  # noqa: E731
    stats = minibatch_stats(torch.from_numpy(adv), block_perm, granule, "sample")
    exact = take(adv).astype(np.float64)
    np.testing.assert_allclose(stats[1, 0].item(), exact.std(), rtol=1e-5)
    nadv = (torch.from_numpy(take(adv)) - stats[0, 0]) / (stats[1, 0] + 1e-8)
    grads, _ = grad_step_plain(leaves_from_flax(flax_params), *(torch.from_numpy(take(x)) for x in (obs, act, logp)),
                               nadv, torch.from_numpy(take(ret)), SweepHypers(**dict(HP, ent_coef=0.0)))

    with jax.enable_x64(False):
        learner = JaxPPOLearner(NanogridConfig(num_chargers=8))
        args = tuple(jnp.asarray(take(x)) for x in (obs, act, logp, np.zeros_like(ret), adv, ret))
        want, _ = jax.grad(learner._loss, has_aux=True)(flax_params, *args)
    got = leaves_to_flax(grads)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                                         atol=1e-5 * float(np.abs(np.asarray(w)).max())),
                 got, want)


@pytest.mark.parametrize("F_", [5, 17, 25, 200])
@pytest.mark.parametrize("A_", [1, 5, 9])
def test_pick_chunk_equals_jax(F_, A_):
    for M in (1, 96, 768, 3072, 24_576, 98_304, 7 * 11 * 13 * 24):
        for H in ((64, 64), (256, 128)):
            assert pick_chunk(M, F_, A_, *H) == _pick_chunk(M, F_, A_, *H)


def test_flat_leaves_match_the_jax_flatten():
    flax_params = flax_net(9)
    with jax.enable_x64(False):
        jax_flat = np.concatenate([np.asarray(x).reshape(-1) for x in _flatten_actor_critic(flax_params)])
    np.testing.assert_array_equal(flatten_leaves(leaves_from_flax(flax_params)).numpy(), jax_flat)


def test_streamed_rejects_bad_blocks():
    leaves = leaves_from_flax(flax_net(1))
    data = [torch.from_numpy(x) for x in sweep_data(1, (64,))]
    with pytest.raises(ValueError, match="outside"):
        ppo_sweep_streamed(leaves, zeros_adam(leaves), *data, torch.tensor([[0, 2]]), 32,
                           SweepHypers(**HP), data_layout="sample")
    with pytest.raises(ValueError, match="not divisible"):
        ppo_sweep_streamed(leaves, zeros_adam(leaves), *data, torch.tensor([[0]]), 48,
                           SweepHypers(**HP), data_layout="sample")


@pytest.mark.parametrize("M", [1, 50, 300, 3072, 9000])
def test_kernel_order_sum_follows_the_partition(M):
    """The twin's sample sums against a loop written from the partition
    constants: samples in order within a tile of GRAD_TILE, the tiles of a
    range in order, then the ranges (at most MAX_GRAD_BLOCKS of
    ceil(M / ranges) samples; the last may be short or empty)."""
    x = np.random.default_rng(M).standard_normal((2, M)).astype(np.float32)
    ranges = max(1, min(MAX_GRAD_BLOCKS, -(-M // GRAD_TILE)))
    per_range = -(-M // ranges)
    want = []
    for row in x:
        total = None
        for r in range(ranges):
            part = np.float32(0.0)
            for t0 in range(r * per_range, min(M, (r + 1) * per_range), GRAD_TILE):
                tile = row[t0:min(t0 + GRAD_TILE, (r + 1) * per_range, M)]
                acc = tile[0]
                for v in tile[1:]:
                    acc = acc + v
                part = acc if t0 == r * per_range else part + acc
            total = part if total is None else total + part
        want.append(total)
    np.testing.assert_array_equal(_kernel_order_sum(torch.from_numpy(x)).numpy(), np.array(want, np.float32))


def test_adam_block_norm_follows_the_slices():
    """The twin's global norm against a loop written from NORM_SLICES: each
    slice of ceil(P / NORM_SLICES) elements sums its squares in order, then
    the slices' sums are added in order (P of the 64x64 actor-critic)."""
    g = (1e-2 * np.random.default_rng(1).standard_normal(12_307)).astype(np.float32)
    size = -(-g.size // NORM_SLICES)
    total = None
    for start in range(0, g.size, size):
        sq = g[start] * g[start]
        for v in g[start + 1:start + size]:
            sq = sq + v * v
        total = sq if total is None else total + sq
    assert _adam_block_norm(torch.from_numpy(g)).item() == np.sqrt(total)
