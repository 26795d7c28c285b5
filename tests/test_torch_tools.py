"""The port's CLIs (``smart_nanogrid_gym_torch/tools/``) on the CPU, mirroring
``tests/test_tools.py`` and held against the JAX package where both produce
the same thing.

- ``train_ppo`` 2 epochs + ``--resume`` to 3 equals the straight 3-epoch run
  (params, Adam moments and count, batteries: ``torch.equal``), through the
  NaN guard, and writes a ``progress.csv`` row per epoch.
- ``train_ppo --impl kernel`` (K2's and K3's twins), ``train_ddpg``,
  ``train_multi``, ``evaluate --models-root --at-scale 1`` (K6's twin),
  ``predict --plot`` (its 28 JSON keys equal to the JAX CLI's) and
  ``visualize``.
- The committed PPO and DDPG artifacts act alike through the port's loading
  and the JAX ``policy_fn`` on the same ``.npz``.
- ``--mesh``/``--distributed`` raise ``NotImplementedError``, ``--device cuda``
  without a card raises.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig as JaxConfig
from smart_nanogrid_gym_tpu.solvers.ddpg import DDPGLearner as JaxDDPGLearner
from smart_nanogrid_gym_tpu.solvers.ppo import PPOLearner as JaxPPOLearner

from smart_nanogrid_gym_torch.core import NanogridConfig
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.solvers import DDPGLearner, PPOLearner, evaluate_policy_at_scale
from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_leaves
from smart_nanogrid_gym_torch.tools import evaluate, predict, train_ddpg, train_multi, train_ppo, visualize
from smart_nanogrid_gym_torch.utils import latest_step, restore_checkpoint
from smart_nanogrid_gym_torch.utils.weights import unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")
PPO_RUN = "PPO-basic-bounded-sparse-4ch-1.0h"
ENV = ["--variant", "basic", "--num-chargers", "4", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in parallel workers, and
    torch's thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ppo_args(models_dir, epochs, extra=()):
    return ENV + ["--batch", "8", "--epochs", str(epochs), "--episodes-per-epoch", "8", "--seed", "3",
                  "--models-dir", str(models_dir), "--guard", *extra]


def test_train_ppo_resume_equals_straight_run(tmp_path):
    straight = train_ppo.main(_ppo_args(tmp_path / "a", 3))
    train_ppo.main(_ppo_args(tmp_path / "b", 2))
    resumed = train_ppo.main(_ppo_args(tmp_path / "b", 3, ["--resume"]))
    for got, want in zip(resumed.params + resumed.opt_state.mu + resumed.opt_state.nu + [resumed.batt_soc],
                         straight.params + straight.opt_state.mu + straight.opt_state.nu + [straight.batt_soc]):
        assert torch.equal(got, want)
    assert resumed.opt_state.count == straight.opt_state.count == 3 * 10 * 4
    assert resumed.update_step == straight.update_step == 3
    run = tmp_path / "a" / PPO_RUN
    assert sorted(os.listdir(run / "full")) == ["1", "2", "3"] and latest_step(str(run)) == 3 * 8 * 24
    assert len((run / "logs" / "progress.csv").read_text().splitlines()) == 1 + 3
    assert json.loads((run / "config.json").read_text())["num_chargers"] == 4
    params = restore_checkpoint(str(run), 3 * 8 * 24, straight.params)
    assert all(torch.equal(a, b) for a, b in zip(params, straight.params))


@pytest.fixture(scope="module")
def trained_root(tmp_path_factory):
    """A models root holding a PPO run and a DDPG run (one epoch each)."""
    root = tmp_path_factory.mktemp("models")
    train_ppo.main(ENV + ["--batch", "8", "--epochs", "1", "--episodes-per-epoch", "8", "--models-dir", str(root)])
    train_ddpg.main(ENV + ["--batch", "8", "--epochs", "1", "--episodes-per-epoch", "8", "--models-dir", str(root)])
    return root


def test_train_ddpg_cli(tmp_path):
    state = train_ddpg.main(ENV + ["--batch", "8", "--epochs", "1", "--episodes-per-epoch", "8",
                                   "--models-dir", str(tmp_path)])
    run = tmp_path / "DDPG-basic-bounded-sparse-4ch-1.0h"
    assert state.update_step == 1 and latest_step(str(run)) == 8 * 24
    assert state.buffer.filled == 24 and len((run / "logs" / "progress.csv").read_text().splitlines()) == 1 + 1


def test_train_ppo_cli_kernel_route(tmp_path):
    """``--impl kernel`` trains through K2's and K3's twins here (the card
    runs the kernels, ``chip_smoke.py`` phase 29)."""
    state = train_ppo.main(ENV + ["--batch", "8", "--epochs", "1", "--episodes-per-epoch", "8", "--impl", "kernel",
                                  "--models-dir", str(tmp_path)])
    assert state.update_step == 1 and state.opt_state.count == 10 * 4
    assert all(bool(torch.isfinite(x).all()) for x in state.params)


def test_evaluate_models_root_at_scale(trained_root, capsys):
    results = evaluate.main(ENV + ["--days", "8", "--models-root", str(trained_root), "--at-scale", "1"])
    names = {name.split("@")[0] for name in results}
    assert names == {"RBC", "idle", PPO_RUN, "DDPG-basic-bounded-sparse-4ch-1.0h"}
    report = json.loads(capsys.readouterr().out)
    # the at-scale figure is evaluate_policy_at_scale's (K6's twin) on the restored actor
    cfg = NanogridConfig(num_chargers=4, pv_system=False, battery_system=False)
    step = latest_step(str(trained_root / PPO_RUN))
    params = make_params(cfg, torch.float32, "cpu")
    template = PPOLearner(cfg, device="cpu").init(0, params, 1).params
    leaves = restore_checkpoint(str(trained_root / PPO_RUN), step, template)
    want = evaluate_policy_at_scale(cfg, params, actor_critic_from_leaves(leaves), num_days=1, seed=0)
    assert report[f"{PPO_RUN}@{step} (at-scale)"] == want and want["total_days"] == 4096


def test_evaluate_skips_an_orbax_step(capsys):
    run = os.path.join(ARTIFACTS, "PPO-b-pv-bounded-sparse-4ch-1h")
    results = evaluate.main(["--num-chargers", "4", "--days", "4", "--device", "cpu", "--models-dir", run,
                             "--checkpoint-step", "9830400"])
    assert set(results) == {"RBC", "idle"}
    assert capsys.readouterr().out.startswith(f"# skipping {run}: step 9830400 holds no state.pt")


def test_train_multi_cli(tmp_path):
    results = train_multi.main(["--algos", "ppo", "--variants", "basic", "--num-chargers", "4", "--batch", "8",
                                "--epochs", "1", "--episodes-per-epoch", "8", "--models-dir", str(tmp_path),
                                "--eval-days", "4", "--device", "cpu"])
    assert any(name.startswith("PPO-basic") for name in results["basic"])


def _prediction_keys(out_dir):
    files = [os.path.join(r, f) for r, _, fs in os.walk(out_dir) for f in fs if f.endswith("-prediction_results.json")]
    assert files
    with open(files[0]) as fp:
        return set(json.load(fp)), files[0]


def test_predict_plot_and_visualize(tmp_path, capsys):
    from smart_nanogrid_gym_tpu.tools.predict import main as jax_predict

    run = os.path.join(ARTIFACTS, "PPO-b-pv-bounded-sparse-4ch-1h")
    predict.main(["--num-chargers", "4", "--seed", "5", "--device", "cpu", "--models-dir", run, "--with-rbc",
                  "--out", str(tmp_path / "out"), "--plot", str(tmp_path / "bars.png")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["day_returns"]) == {"PPO-b-pv-bounded-sparse-4ch-1h@108134400", "RBC"}
    assert all(np.isfinite(v) for v in out["day_returns"].values()) and "day_return" not in out
    assert (tmp_path / "bars.png").stat().st_size > 5_000
    ret = predict.main(["--num-chargers", "4", "--device", "cpu", "--out", str(tmp_path / "rbc")])
    assert np.isfinite(ret)
    jax_predict(["--num-chargers", "4", "--out", str(tmp_path / "jax")])
    keys, results = _prediction_keys(tmp_path / "rbc")
    assert keys == _prediction_keys(tmp_path / "jax")[0] and len(keys) == 28

    fig = visualize.main(["--results", results, "--out", str(tmp_path / "fig.png"),
                          "--html", str(tmp_path / "day.html")])
    assert os.path.getsize(fig) > 10_000 and "const PANELS" in (tmp_path / "day.html").read_text()


@pytest.mark.parametrize("algo", ["ppo", "ddpg"])
def test_artifact_actions_equal_jax(algo):
    """The committed artifact's actions through the port's checkpoint loading
    and through the JAX learner's ``policy_fn`` on the same ``.npz``."""
    kw = dict(num_chargers=4, pv_system=True, battery_system=True)
    cfg, jcfg = NanogridConfig(**kw), JaxConfig(**kw)
    run, step = {"ppo": ("PPO-b-pv-bounded-sparse-4ch-1h", 108134400),
                 "ddpg": ("DDPG-b-pv-bounded-sparse-4ch-1h", 49152000)}[algo]
    run = os.path.join(ARTIFACTS, run)
    params = make_params(cfg, torch.float32, "cpu")
    if algo == "ppo":
        learner = PPOLearner(cfg, device="cpu")
        template = learner.init(0, params, 1).params
        jax_learner = JaxPPOLearner(jcfg)
    else:
        learner = DDPGLearner(cfg, device="cpu")
        template = learner.init(0, params, 1).actor
        jax_learner = JaxDDPGLearner(jcfg)
    leaves = evaluate.load_checkpoint_leaves(run, step, algo == "ddpg", cfg, template)
    with np.load(os.path.join(run, f"{step}.npz")) as data:
        tree = unflatten({k: jnp.asarray(data[k]) for k in data.files})
    obs = np.random.default_rng(1).random((256, cfg.obs_dim), dtype=np.float32)
    got = learner.policy_fn(leaves)(torch.from_numpy(obs)).numpy()
    want = np.asarray(jax_learner.policy_fn(tree)(jnp.asarray(obs)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cli, argv, error", [
    (train_ppo, ["--mesh"], NotImplementedError),
    (train_ppo, ["--distributed"], NotImplementedError),
    (train_ppo, [], RuntimeError),
    (train_ddpg, [], RuntimeError),
    (evaluate, [], RuntimeError),
    (predict, [], RuntimeError),
    (train_multi, ["--algos", "ppo"], RuntimeError),
])
def test_cli_refuses(monkeypatch, tmp_path, cli, argv, error):
    """``--mesh``/``--distributed`` are not ported; ``--device cuda`` (the
    default) without a card raises and never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match="parallel/" if error is NotImplementedError else "needs a CUDA card"):
        cli.main(argv + ["--models-dir", str(tmp_path)])
