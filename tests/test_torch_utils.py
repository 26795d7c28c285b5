"""The port's ``utils/`` (metrics, checkpoint, guard, profiling) and
``compat/sb3_loader.py`` against the JAX package's on the CPU.

- ``progress.csv`` and the tfevents records are byte-equal to the JAX
  ``MetricsWriter``'s for the same ``add()`` calls with ``time.time`` pinned,
  through a fresh run, a resume with the same schema and a schema mismatch;
  ``_crc32c`` meets the RFC 3720 vectors.
- ``config.json`` is byte-equal to the JAX sidecar for the four variants.
- Both train states round-trip with ``torch.equal`` on every tensor, equal
  generator states, and an equal next update.
- ``TrainGuard`` rolls back a poisoned update (the JAX guard test's script).
- ``device_trace`` writes a Chrome trace that holds the port's ``ng.``
  spans (a param guard's ``ng.guard``).
- An SB3-format zip written here with ``torch.save`` loads through both
  loaders into equal arrays, and both ``make_sb3_policy_fn``s act alike.
"""

import collections
import io
import json
import os
import time
import zipfile
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.compat import sb3_loader as jax_sb3
from smart_nanogrid_gym_tpu.core import NanogridConfig as JaxConfig
from smart_nanogrid_gym_tpu.utils import checkpoint as jax_checkpoint, metrics as jax_metrics

from smart_nanogrid_gym_torch.compat import sb3_loader
from smart_nanogrid_gym_torch.core import NanogridConfig
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops.param_guard import check_baked_params
from smart_nanogrid_gym_torch.solvers import DDPGConfig, DDPGLearner, PPOConfig, PPOLearner
from smart_nanogrid_gym_torch.tools.train_ppo import VARIANTS
from smart_nanogrid_gym_torch.utils import device_trace, latest_step, restore_checkpoint, save_checkpoint
from smart_nanogrid_gym_torch.utils import metrics
from smart_nanogrid_gym_torch.utils.checkpoint import tree_leaves
from smart_nanogrid_gym_torch.utils.guard import TrainGuard, check_finite, reseeded


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in parallel workers, and
    torch's thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ metrics ---


@pytest.mark.parametrize("data, crc", [(b"", 0), (b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA),
                                       (b"\xff" * 32, 0x62A8AB43), (bytes(range(32)), 0x46DD794E)])
def test_crc32c_known_vectors(data, crc):
    assert metrics._crc32c(data) == crc == jax_metrics._crc32c(data)
    assert metrics._masked_crc(data) == jax_metrics._masked_crc(data)


def _write_runs(module, log_dir, scenario):
    with module.MetricsWriter(log_dir) as w:
        w.add(10, loss=0.5, reward=-100.0)
        w.add(20, loss=0.25, reward=-50.125)
        with pytest.raises(ValueError, match="new metric"):
            w.add(30, other=1.0)
    if scenario == "resume":
        with module.MetricsWriter(log_dir) as w:
            w.add(40, reward=-25.0, loss=0.125)
    elif scenario == "mismatch":
        w = module.MetricsWriter(log_dir)
        with pytest.raises(ValueError, match="has header"):
            w.add(40, loss=1.0)
        w.close()


@pytest.mark.parametrize("scenario", ["fresh", "resume", "mismatch"])
def test_metrics_files_equal_jax(tmp_path, monkeypatch, scenario):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    for module, name in ((metrics, "torch"), (jax_metrics, "jax")):
        _write_runs(module, str(tmp_path / name), scenario)
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 2
    for f in names:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    rows = (tmp_path / "torch" / "progress.csv").read_text().splitlines()
    assert rows[0] == "step,loss,reward" and len(rows) == (4 if scenario == "resume" else 3)


# --------------------------------------------------------------- checkpoint ---


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_json_equals_jax(tmp_path, variant):
    kw = dict(num_chargers=6, time_interval=0.5, penalty_mode="dense", **VARIANTS[variant])
    save_checkpoint(str(tmp_path / "torch"), 7, [torch.zeros(2)], env_config=NanogridConfig(**kw))
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), 7, [np.zeros(2, np.float32)], env_config=JaxConfig(**kw))
    got = (tmp_path / "torch" / "config.json").read_bytes()
    assert got == (tmp_path / "jax" / "config.json").read_bytes()
    assert json.loads(got)["penalty_mode"] == 3


def _ppo(seed):
    cfg = NanogridConfig(num_chargers=4)
    learner = PPOLearner(cfg, PPOConfig(num_epochs=1, num_minibatches=2), device="cpu")
    return learner, learner.init(seed, make_params(cfg, torch.float32, "cpu"), 8)


def _ddpg(seed):
    cfg = NanogridConfig(num_chargers=4)
    learner = DDPGLearner(cfg, DDPGConfig(buffer_days=2, gradient_steps=2, batch_size=16), device="cpu")
    return learner, learner.init(seed, make_params(cfg, torch.float32, "cpu"), 8)


def _assert_states_equal(got, want):
    assert type(got) is type(want)
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.device == w.device and torch.equal(g, w)
        elif isinstance(w, torch.Generator):
            assert torch.equal(g.get_state(), w.get_state())
        else:
            assert g == w


@pytest.mark.parametrize("make", [_ppo, _ddpg], ids=["ppo", "ddpg"])
def test_train_state_round_trip(tmp_path, make):
    """A trained state (Adam count 1+, a filled buffer) comes back bit for
    bit into a differently seeded target, and the next update from either is
    the same."""
    learner, state = make(0)
    step = learner.build_train_step()
    state, _ = step(state, learner.nanogrid_params)
    save_checkpoint(str(tmp_path), 1, state)
    assert latest_step(str(tmp_path)) == 1
    restored = restore_checkpoint(str(tmp_path), 1, make(5)[1])
    _assert_states_equal(restored, state)
    a, _ = step(state, learner.nanogrid_params)
    b, _ = step(restored, learner.nanogrid_params)
    _assert_states_equal(a, b)


def test_restore_refuses_another_shape(tmp_path):
    save_checkpoint(str(tmp_path), 3, [torch.zeros(4), 2])
    with pytest.raises(ValueError, match="target torch.float32 \\(5,\\)"):
        restore_checkpoint(str(tmp_path), 3, [torch.zeros(5), 0])
    with pytest.raises(ValueError, match="holds 2 leaves"):
        restore_checkpoint(str(tmp_path), 3, [torch.zeros(4)])


# -------------------------------------------------------------------- guard ---


@pytest.mark.parametrize("tree, finite", [
    ({"a": torch.ones(3), "b": (torch.zeros(2), torch.tensor(1))}, True),
    ({"a": torch.tensor([1.0, float("nan")])}, False),
    ({"a": torch.tensor([float("inf")])}, False),
    ((torch.tensor([2 ** 31 - 1]), 7, torch.Generator(), None), True),
])
def test_check_finite(tree, finite):
    assert check_finite(tree) is finite


class S(NamedTuple):
    x: torch.Tensor
    generator: torch.Generator


def test_train_guard_recovers_from_nan(tmp_path):
    """A step function that corrupts the state at a specific call must be
    rolled back and routed around by the reseeded generator."""
    calls = {"n": 0}

    def step(state):
        calls["n"] += 1
        # corrupt exactly once, on the 4th call, while the generator is the initial one
        poison = calls["n"] == 4 and state.generator.initial_seed() == 0
        x = state.x + 1
        if poison:
            x = x * float("nan")
        return S(x, state.generator), {"loss": x.sum()}

    guard = TrainGuard(step, str(tmp_path / "g"), save_every=2)
    final = guard.run(S(torch.zeros(2), torch.Generator().manual_seed(0)), 6)
    assert guard.recoveries == 1
    assert bool(torch.isfinite(final.x).all()) and float(final.x[0]) == 6.0
    assert final.generator.initial_seed() == reseeded(torch.Generator().manual_seed(0), 7920).initial_seed() != 0


def test_reseeded_is_deterministic():
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    a, b, c = reseeded(g, 7920), reseeded(g, 7920), reseeded(g, 7921)
    assert torch.equal(g.get_state(), state)
    assert a.initial_seed() == b.initial_seed() != c.initial_seed()


# ---------------------------------------------------------------- profiling ---


def test_profiling_helpers(tmp_path):
    config = NanogridConfig()
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
        check_baked_params(config, make_params(config, torch.float32, "cpu"), "probe")
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1
    events = json.loads((tmp_path / "trace" / traces[0]).read_text())["traceEvents"]
    assert events and "ng.guard" in {e.get("name") for e in events}
    assert prof.key_averages()


# ------------------------------------------------------------------ SB3 zip ---


def _sb3_zip(path, cfg, seed):
    """An SB3 PPO checkpoint as stable-baselines3 writes it: ``policy.pth`` a
    torch-saved state_dict of the default MlpPolicy, ``data`` the JSON."""
    gen = torch.Generator().manual_seed(seed)
    F, A, H = cfg.obs_dim, cfg.num_actions, 64
    shapes = {"log_std": (A,),
              "mlp_extractor.policy_net.0.weight": (H, F), "mlp_extractor.policy_net.0.bias": (H,),
              "mlp_extractor.policy_net.2.weight": (H, H), "mlp_extractor.policy_net.2.bias": (H,),
              "mlp_extractor.value_net.0.weight": (H, F), "mlp_extractor.value_net.0.bias": (H,),
              "mlp_extractor.value_net.2.weight": (H, H), "mlp_extractor.value_net.2.bias": (H,),
              "action_net.weight": (A, H), "action_net.bias": (A,),
              "value_net.weight": (1, H), "value_net.bias": (1,)}
    state = collections.OrderedDict((k, 0.3 * torch.randn(s, generator=gen)) for k, s in shapes.items())
    buf = io.BytesIO()
    torch.save(state, buf)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("policy.pth", buf.getvalue())
        z.writestr("data", json.dumps({"gamma": 0.99, "gae_lambda": 0.95, "n_steps": 2048}))
    return state


def test_sb3_zip_loads_equal_in_both(tmp_path):
    kw = dict(num_chargers=4, pv_system=True, battery_system=True)
    cfg, jcfg = NanogridConfig(**kw), JaxConfig(**kw)
    path = str(tmp_path / "PPO-run" / "1200.zip")
    os.makedirs(os.path.dirname(path))
    state = _sb3_zip(path, cfg, 4)
    leaves, hyper = sb3_loader.load_sb3_actor_critic(path, cfg)
    jax_params, jax_hyper = jax_sb3.load_sb3_actor_critic(path, jcfg)
    assert hyper == jax_hyper and hyper["gamma"] == 0.99
    p = jax_params["params"]
    want = [p[net][f"Dense_{i}"][kind].T if kind == "kernel" else p[net][f"Dense_{i}"][kind]
            for net in ("pi", "vf") for i in range(3) for kind in ("kernel", "bias")] + [p["log_std"]]
    for got, w, name in zip(leaves, want, sb3_loader._PPO_TENSOR_NAMES, strict=True):
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(got.numpy(), state[name].numpy())
    obs = np.random.default_rng(0).random((64, cfg.obs_dim), dtype=np.float32)
    got = sb3_loader.make_sb3_policy_fn(cfg, leaves)(torch.from_numpy(obs)).numpy()
    want = np.asarray(jax_sb3.make_sb3_policy_fn(jcfg, {"params": jax_params["params"]})(jnp.asarray(obs)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    low, high = cfg.action_bounds()
    assert (got >= low).all() and (got <= high).all() and (got == high).any()
    with pytest.raises(ValueError, match="config needs"):
        sb3_loader.load_sb3_actor_critic(path, NanogridConfig(num_chargers=8))
