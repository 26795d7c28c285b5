"""Parity helpers for the PyTorch port's tests: build JAX inputs on the CPU,
convert them to the port's tensor containers and back, and restore the
committed PPO and DDPG artifacts.

Kept outside ``smart_nanogrid_gym_torch`` so that the port itself never
imports JAX, flax or orbax.  Run as a script to (re)write the artifact's
numpy copies: ``PYTHONPATH=. python tests/torch_parity.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from smart_nanogrid_gym_torch.core.params import NanogridParams
from smart_nanogrid_gym_torch.core.state import DaySchedule, EnvState
from smart_nanogrid_gym_torch.core.config import NanogridConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT_DIR = os.path.join(REPO, "artifacts", "PPO-b-pv-bounded-sparse-4ch-1h")
ARTIFACT_STEP = 108_134_400
ARTIFACT_NPZ = os.path.join(ARTIFACT_DIR, f"{ARTIFACT_STEP}.npz")
DDPG_ARTIFACT_DIR = os.path.join(REPO, "artifacts", "DDPG-b-pv-bounded-sparse-4ch-1h")
DDPG_ARTIFACT_STEP = 49_152_000
DDPG_ARTIFACT_NPZ = os.path.join(DDPG_ARTIFACT_DIR, f"{DDPG_ARTIFACT_STEP}.npz")


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def params_to_torch(params) -> NanogridParams:
    return NanogridParams(*(to_torch(x) for x in params))


def schedule_to_torch(schedule) -> DaySchedule:
    return DaySchedule(*(to_torch(x) for x in schedule))


def state_to_torch(state) -> EnvState:
    """A batched JAX ``EnvState`` (leaves ``(B, ...)``) as the port's state;
    the JAX PRNG key has no counterpart."""
    return EnvState(
        t=to_torch(state.t).to(torch.int64),
        soc=to_torch(state.soc),
        schedule=schedule_to_torch(state.schedule),
        batt_soc=to_torch(state.batt_soc),
        batt_init_soc=to_torch(state.batt_init_soc),
        pv_shift=to_torch(state.pv_shift),
        pmask=to_torch(state.pmask),
        day=to_torch(state.day).to(torch.int64),
    )


def artifact_config(directory: str = ARTIFACT_DIR) -> NanogridConfig:
    with open(os.path.join(directory, "config.json")) as fp:
        meta = json.load(fp)
    return NanogridConfig(
        num_chargers=meta["num_chargers"],
        pv_system=meta["pv_system"],
        battery_system=meta["battery_system"],
        vehicle_to_everything=meta["vehicle_to_everything"],
        penalty_mode=meta["penalty_mode"],
        time_interval=meta["time_interval"],
    )


def restore_artifact():
    """The artifact's flax params as stored (f32), restored through the JAX package."""
    import jax
    import jax.numpy as jnp

    from smart_nanogrid_gym_tpu.core import make_params
    from smart_nanogrid_gym_tpu.solvers.ppo import PPOLearner
    from smart_nanogrid_gym_tpu.utils.checkpoint import restore_checkpoint

    config = artifact_config()
    with jax.enable_x64(False):
        learner = PPOLearner(config)
        template = learner.init(jax.random.PRNGKey(0), make_params(config, dtype=jnp.float32),
                                batch_size=1).params
        return restore_checkpoint(ARTIFACT_DIR, ARTIFACT_STEP, template)


def restore_ddpg_artifact():
    """The DDPG artifact's actor params as stored (f32): the checkpoint holds
    only ``actor_params``, restored with the actor template
    (tests/test_artifacts.py)."""
    import jax
    import jax.numpy as jnp

    from smart_nanogrid_gym_tpu.core import make_params
    from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGConfig, DDPGLearner
    from smart_nanogrid_gym_tpu.utils.checkpoint import restore_checkpoint

    config = artifact_config(DDPG_ARTIFACT_DIR)
    with jax.enable_x64(False):
        learner = DDPGLearner(config, DDPGConfig(buffer_days=2, gradient_steps=1))
        template = learner.init(jax.random.PRNGKey(0), make_params(config, dtype=jnp.float32),
                                batch_size=1).actor_params
        return restore_checkpoint(DDPG_ARTIFACT_DIR, DDPG_ARTIFACT_STEP, template)


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}`` with numpy leaves."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def write_artifact_npz(path: str = ARTIFACT_NPZ) -> str:
    np.savez(path, **flatten(restore_artifact()))
    return path


def write_ddpg_artifact_npz(path: str = DDPG_ARTIFACT_NPZ) -> str:
    np.savez(path, **flatten(restore_ddpg_artifact()))
    return path


def kernel_inputs(config, seed: int, batch: int = 128):
    """Numpy uniforms ``(T, 5, N, B)`` and PV shifts ``(B,)`` in f32, the inputs
    of the explicit-uniform kernels."""
    rng = np.random.default_rng(seed)
    u = rng.random((config.steps_per_day, 5, config.num_chargers, batch)).astype(np.float32)
    pv = (rng.integers(0, 181, batch) / 100.0).astype(np.float32)
    return u, pv


def shifted_flax_actor(config, seed: int):
    """Fresh flax ActorCritic params with the action-mean biases pushed off the
    0 branch boundaries (as tests/test_pallas.py does); with v2x, chargers
    alternate charge and discharge so both branches run."""
    import jax
    import jax.numpy as jnp

    from smart_nanogrid_gym_tpu.solvers.networks import ActorCritic as FlaxActorCritic

    net = FlaxActorCritic(action_dim=config.num_actions)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, config.obs_dim), jnp.float32))
    if config.vehicle_to_everything:
        ch_bias = np.where(np.arange(config.num_chargers) % 2 == 0, 0.5, -0.4)
    else:
        ch_bias = np.full(config.num_chargers, 0.5)
    bias = np.concatenate([ch_bias, [-0.3]] if config.battery_system else [ch_bias]).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(bias)
        if "Dense_2" in str(path) and "pi" in str(path) and "bias" in str(path) else x,
        params,
    )
    return jax.tree.map(np.asarray, params)


def flax_ddpg_actor(config, seed: int, hidden=(400, 300), shift: bool = True):
    """Fresh flax DDPGActor params (numpy), with the output biases pushed off
    the 0 branch boundaries (tests/test_pallas.py:252-263): 0.4 per charger
    (0.5/-0.4 alternating with v2x), -0.6 for the battery."""
    import jax
    import jax.numpy as jnp

    from smart_nanogrid_gym_tpu.solvers.networks import DDPGActor as FlaxDDPGActor

    low, high = config.action_bounds()
    net = FlaxDDPGActor(config.num_actions, tuple(low.tolist()), tuple(high.tolist()), hidden)
    with jax.enable_x64(False):
        params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, config.obs_dim), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    if shift:
        if config.vehicle_to_everything:
            ch_bias = np.where(np.arange(config.num_chargers) % 2 == 0, 0.5, -0.4)
        else:
            ch_bias = np.full(config.num_chargers, 0.4)
        bias = np.concatenate([ch_bias, [-0.6]] if config.battery_system else [ch_bias]).astype(np.float32)
        params["params"]["mu"]["Dense_2"]["bias"] = bias
    return params


def assert_bf16_close(got, want, f32, rtol, atol, bound, msg, share=0.999, ratio=0.5):
    """The contract of the bf16 tests (tests/test_torch_bf16_*.py) on lists
    of float arrays: ``got`` the port's bf16 result, ``want`` JAX's bf16
    result, ``f32`` the f32 result of the same computation.

    A bf16 twin rounds its product operands as the JAX kernel does but sums
    in another order than XLA, so an operand near a bf16 rounding boundary
    can round one way in one package and the other way in the other.  So:
    at least ``share`` of the entries keep the relation "the port is as
    close to JAX's bf16 result as the f32 result is", within the f32
    tolerance (``rtol``, ``atol``); every entry lies within ``bound`` of
    JAX's; and the summed absolute distance to JAX's bf16 result is below
    ``ratio`` times the f32 result's, so the test tells that bf16 happened.
    """
    g, w, f = (np.concatenate([np.asarray(x, np.float64).reshape(-1) for x in xs]) for xs in (got, want, f32))
    relation = np.abs(g - w) <= np.abs(f - w) + atol + rtol * np.abs(w)
    assert relation.mean() >= share, (msg, relation.mean())
    np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=msg)
    d_port, d_f32 = np.abs(g - w).sum(), np.abs(f - w).sum()
    assert d_port < ratio * d_f32, (msg, d_port, d_f32)


def k6_bf16_close(got, want, f32, msg, share=0.99, mean_rel=0.005):
    """The contract of K6's bf16 block actor on the tensor cores: ``got`` its
    stats ``(3, B)``, ``want`` the bf16 twin's, ``f32`` the f32 kernel's on
    the same days.  The tensor cores sum in their own order, so a bit-equal
    twin is not the bar: for at least ``share`` of the envs, the Σ day return
    and the final battery are as close to the twin's as the f32 kernel's are
    (rtol 1e-4, atol 1e-6), and the mean day return lies within ``mean_rel``
    of the twin's (PERF.md §2's bf16 bar).  Returns the observed shares, the
    relative gap of the means and the max abs error."""
    g, w, f = (x.double().cpu() for x in (got, want, f32))
    shares = [float(((g[r] - w[r]).abs() <= (f[r] - w[r]).abs() + 1e-6 + 1e-4 * w[r].abs()).double().mean())
              for r in (0, 2)]
    rel = abs(float(g[0].sum() - w[0].sum())) / abs(float(w[0].sum()))
    assert torch.isfinite(g).all(), msg
    assert min(shares) >= share and rel < mean_rel, (msg, shares, rel)
    return shares, rel, float((g - w).abs().max())


if __name__ == "__main__":
    print(write_artifact_npz())
    print(write_ddpg_artifact_npz())


def step_leaves(result, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every tensor of a ``StepResult`` (or any tree of named tuples) by its
    dotted path."""
    out = {}
    for name, value in zip(result._fields, result):
        if isinstance(value, tuple):
            out.update(step_leaves(value, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = value
    return out


def alias_classes(leaves: dict[str, torch.Tensor]) -> list[int]:
    """For each leaf in order, the index of the first leaf that is the same
    view of the same memory (pointer, shape and strides)."""
    first: dict = {}
    return [first.setdefault((x.data_ptr(), tuple(x.shape), x.stride()), i) for i, x in enumerate(leaves.values())]


def assert_same_step(got, want) -> None:
    """Two ``StepResult``s equal leaf by leaf (``torch.equal``, the same dtype
    and shape), with the same leaves aliasing one another."""
    g, w = step_leaves(got), step_leaves(want)
    assert list(g) == list(w)
    for name in w:
        assert g[name].dtype == w[name].dtype and g[name].shape == w[name].shape, name
        if not torch.equal(g[name], w[name]):
            raise AssertionError(f"{name}: max |d| {float((g[name].double() - w[name].double()).abs().max()):.3e}")
    assert alias_classes(g) == alias_classes(w)
