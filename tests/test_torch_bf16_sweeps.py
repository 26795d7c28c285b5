"""The bf16 operand option (``matmul_dtype``) of the PyTorch port's sweep
twins K3/K4 and K10, with the JAX kernels in interpret mode as the
reference, under the contract of :func:`torch_parity.assert_bf16_close`
(its f32 reference: the same JAX kernel in f32).

After one step every product's operands round alike on both sides, so the
twins agree with JAX's bf16 kernels to f32 rounding.  Over the steps the
rounding-boundary flips compound through Adam, in K10's actor most: after 8
steps 98.2 % of its parameters keep the relation within the f32 tolerance
(measured with these inputs), and the contract asserts 97 % there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.ops.pallas_ddpg_sweep import DDPGSweepHypers as JaxDDPGHypers
from smart_nanogrid_gym_tpu.ops.pallas_ppo_sweep import SweepHypers as JaxHypers, ppo_sweep_pallas, \
    ppo_sweep_pallas_streamed

from smart_nanogrid_gym_torch.ops.ddpg_sweep import DDPGSweepHypers
from smart_nanogrid_gym_torch.ops.ppo_sweep import SweepHypers, ppo_sweep, ppo_sweep_streamed, zeros_adam
from smart_nanogrid_gym_torch.utils.weights import leaves_from_flax

from test_torch_ddpg_sweep import inputs as ddpg_inputs, pallas_sweep, port_sweep
from test_torch_ppo_sweep import HP, flax_net, normalise, sweep_data
from torch_parity import assert_bf16_close

BF16 = torch.bfloat16


def port_leaves(params, adam):
    return [x.detach().numpy() for x in list(params) + list(adam.mu) + list(adam.nu)]


def jax_leaves(p, mu, nu):
    """A JAX sweep's params and moments in the port's leaf order."""
    def flat(tree):
        return [x.numpy() for x in leaves_from_flax(jax.tree.map(np.asarray, tree))]

    return flat(p) + flat(mu) + flat(nu)


def check_ppo(got, want, f32, G, msg):
    """Params within 4·G·lr (Adam moves a parameter by at most about lr a
    step) and moments within 1e-2, at the f32 tests' rtol (1e-5 after one
    step, 1e-4 after four) and atol 1e-6."""
    rtol = 1e-5 if G == 1 else 1e-4
    assert all(x.dtype == np.float32 for x in got)
    assert_bf16_close(got[:13], want[:13], f32[:13], rtol, 1e-6, 4 * G * HP["lr"], f"{msg} params")
    assert_bf16_close(got[13:], want[13:], f32[13:], rtol, 1e-6, 1e-2, f"{msg} moments")


@pytest.mark.parametrize("G", [1, 4])
def test_k4_bf16_twin_matches_pallas_sweep(G):
    """K4's twin with ``matmul_dtype=bf16`` against ``ppo_sweep_pallas`` with
    ``SweepHypers(matmul_dtype=jnp.bfloat16)``."""
    flax_params = flax_net(1)
    obs, act, logp, adv, ret = sweep_data(2, (G, 96))
    nadv = normalise(adv)
    data = tuple(jnp.asarray(x) for x in (obs, act, logp, nadv, ret))
    outs = {}
    with jax.enable_x64(False):
        zeros = jax.tree.map(jnp.zeros_like, flax_params)
        for name, mm in (("bf16", jnp.bfloat16), ("f32", None)):
            p, _, mu, nu, met = ppo_sweep_pallas(flax_params, jnp.int32(3), zeros, zeros, *data,
                                                 JaxHypers(**HP, matmul_dtype=mm), interpret=True)
            outs[name] = jax_leaves(p, mu, nu), np.asarray(met)
    leaves = leaves_from_flax(flax_params)
    p, adam, met = ppo_sweep(leaves, zeros_adam(leaves)._replace(count=3),
                             *(torch.from_numpy(x) for x in (obs, act, logp, nadv, ret)),
                             SweepHypers(**HP, matmul_dtype=BF16))
    assert adam.count == 3 + G
    check_ppo(port_leaves(p, adam), outs["bf16"][0], outs["f32"][0], G, "K4")
    np.testing.assert_allclose(met.numpy(), outs["bf16"][1], rtol=1e-3, atol=1e-5, err_msg="metrics")


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("layout", ["featlane", "sample"])
def test_k3_bf16_twin_matches_pallas_streamed(layout, G):
    """K3's twin with ``matmul_dtype=bf16`` in both layouts, as the K4 test."""
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
    outs = {}
    with jax.enable_x64(False):
        zeros = jax.tree.map(jnp.zeros_like, flax_params)
        for name, mm in (("bf16", jnp.bfloat16), ("f32", None)):
            p, _, mu, nu, met = ppo_sweep_pallas_streamed(
                flax_params, jnp.int32(0), zeros, zeros, *(jnp.asarray(x) for x in (obs, act, logp, adv, ret)),
                jnp.asarray(block_perm), granule, JaxHypers(**HP, matmul_dtype=mm), interpret=True,
                data_layout=layout)
            outs[name] = jax_leaves(p, mu, nu), np.asarray(met)
    leaves = leaves_from_flax(flax_params)
    p, adam, met = ppo_sweep_streamed(leaves, zeros_adam(leaves),
                                      *(torch.from_numpy(x) for x in (obs, act, logp, adv, ret)),
                                      torch.from_numpy(block_perm), granule, SweepHypers(**HP, matmul_dtype=BF16),
                                      data_layout=layout)
    check_ppo(port_leaves(p, adam), outs["bf16"][0], outs["f32"][0], G, f"K3 {layout}")
    np.testing.assert_allclose(met.numpy(), outs["bf16"][1], rtol=1e-3, atol=1e-5, err_msg="metrics")


@pytest.mark.parametrize("G", [1, 8])
def test_k10_bf16_twin_matches_pallas_sweep(G):
    """K10's twin with ``matmul_dtype=bf16`` against ``ddpg_sweep_pallas`` at
    the f32 K10 test's widths (128-96, M=64): the f32 sweep contract's rtol
    1e-4 / atol 3e-6 and bound G·lr; after 8 steps the relation holds for
    97 % (module docstring)."""
    _, _, a_params, c_params, batches = ddpg_inputs(G, G)
    hp = dict(lr=1e-3, gamma=0.99, tau=5e-3)
    want, want_m = pallas_sweep(a_params, c_params, batches, JaxDDPGHypers(**hp, matmul_dtype=jnp.bfloat16))
    f32, _ = pallas_sweep(a_params, c_params, batches, JaxDDPGHypers(**hp))
    got, got_m = port_sweep(a_params, c_params, batches, hp=DDPGSweepHypers(**hp, matmul_dtype=BF16))
    for key in ("actor_params", "critic_params", "target_actor_params", "target_critic_params"):
        leaves = [jax.tree.leaves(t[key]) for t in (got, want, f32)]
        assert all(np.asarray(x).dtype == np.float32 for x in leaves[0])
        assert_bf16_close(*leaves, 1e-4, 3e-6, G * hp["lr"], key, share=0.999 if G == 1 else 0.97)
    np.testing.assert_allclose(got_m, want_m, rtol=1e-3, atol=1e-4)
