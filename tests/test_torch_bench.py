"""The port's bench (``smart_nanogrid_gym_torch/tools/bench.py``) on the CPU,
at tiny sizes through the kernels' twins, held against the JAX package's
root ``bench.py`` and its committed outputs.

- ``stats_bounds`` equals the root bench's on a grid of inputs.
- ``check_multiday_stats`` passes K8's twin against the plain engine and
  raises when the kernel side's mean is shifted by 10 %; the headline line
  carries the root bench's keys and the card.
- ``bench_all`` returns the committed ``BENCH_TABLE.json``'s row keys, in
  order, each finite and > 0; the train profile carries
  ``TRAIN_PROFILE.json``'s keys; the scaling records run the kernel path in
  this process and the plain engine on two gloo ranks.
- The default outputs are the ``_torch`` files, never the JAX bench's, and
  ``--device cuda`` without a card raises.
"""

import functools
import inspect
import json
import math
import os

import jax
import pytest
import torch

from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_multiday
from smart_nanogrid_gym_torch.solvers import ddpg as ddpg_module, ppo as ppo_module
from smart_nanogrid_gym_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = bench.bench_config()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def params():
    return make_params(CONFIG, torch.float32, "cpu")


@pytest.fixture
def small_learners(monkeypatch):
    """The learners' sweeps cut to a few gradient steps, so that the bench's
    training rows run their twins in seconds on the CPU."""
    monkeypatch.setattr(ppo_module, "PPOConfig", functools.partial(ppo_module.PPOConfig, num_epochs=1))
    monkeypatch.setattr(ddpg_module, "DDPGConfig",
                        functools.partial(ddpg_module.DDPGConfig, gradient_steps=2, batch_size=16))


def load(name):
    with open(os.path.join(REPO, name)) as fp:
        return json.load(fp)


def test_stats_bounds_equal_the_root_bench():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        import bench as root_bench  # the JAX package's bench; its import sets a compile cache
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    grid = [(m, s, nk, no) for m in (-350.0, -1.0, 0.0, 12.5) for s in (0.0, 0.7, 70.0)
            for nk, no in ((16, 16), (1024, 204_800), (1_638_400_000, 204_800))]
    for args in grid:
        assert bench.stats_bounds(*args) == root_bench.stats_bounds(*args), args
    assert bench.REFERENCE_STEPS_PER_SEC == root_bench.REFERENCE_STEPS_PER_SEC
    assert (bench.BATCH, bench.NUM_CALLS_TIMED) == (root_bench.BATCH, root_bench.NUM_CALLS_TIMED)


def test_check_multiday_stats_passes_k8_twin_and_catches_a_shift(params):
    B, days = 64, 16

    def k8(attempt, shift=1.0):
        mean, std = bench.mean_std(gen_rbc_multiday(CONFIG, params, days, 7 + attempt, B), days * B)
        return mean * shift, std

    ref_mean, ref_std = bench.check_multiday_stats(k8, days * B, CONFIG, params, "K8 twin", batch=B,
                                                   oracle_days=days)
    assert -450 < ref_mean < -250 and 40 < ref_std < 100
    with pytest.raises(AssertionError, match="disagree"):
        bench.check_multiday_stats(functools.partial(k8, shift=1.1), days * B, CONFIG, params, "K8 twin x1.1",
                                   batch=B, oracle_days=days)


def test_headline_line_has_the_root_bench_keys(params):
    rate = bench.bench_headline(CONFIG, params, batch=64, days=16, calls=1)
    line = bench.headline_line(rate, bench.card_line(params.device))
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "card"]
    assert line["metric"] == "env_steps_per_sec_per_chip_4096envs" and line["card"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] == round(rate / 1699.0, 2)


def test_bench_all_rows_are_the_jax_tables(params, small_learners, tmp_path):
    depth = {key: 1 for key in bench.ROW_DEPTH}
    depth.update(native_single_env=48, native_batched_1024=24)
    out = tmp_path / "table.json"
    table = bench.bench_all(CONFIG, params, batch=32, depth=depth, calls=1, out_path=str(out))
    assert list(table["paths"]) == list(load("BENCH_TABLE.json")["paths"])
    assert all(math.isfinite(v) and v > 0 for v in table["paths"].values()), table["paths"]
    assert list(table) == ["batch", "config", "unit", "card", "torch", "paths"]
    assert (table["batch"], table["config"], table["unit"], table["card"]) == (32, "8ch b-pv sparse 1h",
                                                                              "env-steps/s", "cpu")
    assert json.loads(out.read_text()) == table


def test_train_profile_keys_are_the_jax_reports(params, small_learners, tmp_path):
    report = bench.bench_train_profile(CONFIG, params, batch=32, reps=1, calls=1, out_path=None)
    want = load("TRAIN_PROFILE.json")
    assert [k for k in report if k not in ("card", "torch")] == list(want)
    assert list(report["phases_sec_per_update"]) == list(want["phases_sec_per_update"])
    phases = report["phases_sec_per_update"]
    assert all(v > 0 for v in phases.values()) and phases["total"] >= phases["rollout"] + phases["gae"]
    assert report["env_steps_per_call"] == 32 * CONFIG.steps_per_day


def test_scaling_records_kernel_path_and_two_gloo_ranks(params, tmp_path):
    out = tmp_path / "scaling.json"
    payload = bench.bench_scaling(CONFIG, params, batch_per_device=8, num_days=1, virtual_ranks=2,
                                  out_path=str(out))
    written = json.loads(out.read_text())
    assert written["records"] == payload["records"] and written["card"] == "cpu"
    (record,) = payload["records"]
    assert record["path"] == "kernel" and record["devices"] == 1 and record["steps_per_sec"] > 0
    virtual = written["platforms"]["cpu_virtual"]
    assert virtual["virtual"] and [r["devices"] for r in virtual["records"]] == [1, 2]
    assert all(r["path"] == "plain" and r["steps_per_sec"] > 0 for r in virtual["records"])


def test_default_outputs_are_the_ports():
    jax_outputs = {os.path.join(REPO, name) for name in ("BENCH_TABLE.json", "SCALING.json", "TRAIN_PROFILE.json")}
    defaults = {os.path.join(bench.ROOT, inspect.signature(fn).parameters["out_path"].default)
                for fn in (bench.bench_all, bench.bench_scaling, bench.bench_train_profile)}
    assert defaults == {os.path.join(REPO, name) for name in
                        ("BENCH_TABLE_torch.json", "SCALING_torch.json", "TRAIN_PROFILE_torch.json")}
    assert not defaults & jax_outputs


@pytest.mark.parametrize("argv", [[], ["--all"], ["--scaling"], ["--train-profile"]])
def test_device_cuda_without_a_card_raises(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        bench.main(argv)
