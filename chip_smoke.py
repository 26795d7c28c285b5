"""Drive the PyTorch port's generated-day evaluation path once on a CUDA card.

Run from the root of the repository, on a machine with one NVIDIA card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written kernels K5-K8 from ``smart_nanogrid_gym_torch/csrc``
with nvcc, holds each against its plain-PyTorch twin on the card, drives the
evaluation path through its user entry points (paired explicit-day
evaluation, the RBC multiday bench run, ``evaluate_policy_at_scale`` with the
committed PPO artifact), checks that every kernel of the path launched and
that the multiday statistics agree with the plain engine, and times each
kernel against its twin.  Any failure raises and exits non-zero.  The last
lines are the card (``nvidia-smi`` name and power limit), one JSON object
with the kernels, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT_NPZ = os.path.join(ROOT, "artifacts", "PPO-b-pv-bounded-sparse-4ch-1h", "108134400.npz")
SOURCE = "smart_nanogrid_gym_torch/csrc/day_step.cuh"
REPLACES = {
    "gen_rbc_day": "smart_nanogrid_gym_tpu/ops/pallas_gen_rollout.py:511",
    "gen_rbc_multiday": "smart_nanogrid_gym_tpu/ops/pallas_gen_rollout.py:580",
    "gen_policy_day": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:439",
    "gen_policy_multiday": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:522",
}
BENCH_BATCH = 4096


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got, want, rtol: float, atol: float) -> float:
    """Kernel against twin, element for element; returns the max abs error."""
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
        err = max(err, float((g - w).abs().max()))
    print(f"{name}: kernel vs twin max_abs_err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def explicit_inputs(config, batch: int, seed: int, device):
    rng = np.random.default_rng(seed)
    u = rng.random((config.steps_per_day, 5, config.num_chargers, batch)).astype(np.float32)
    pv = (rng.integers(0, 181, batch) / 100.0).astype(np.float32)
    return torch.from_numpy(u).to(device), torch.from_numpy(pv).to(device)


def stats_match(label, kernel_fn, oracle_fn, n_kernel, n_oracle, attempts=3):
    """Day-return mean/std of a multiday kernel against the plain engine:
    z=6 bounds of the sampling error, floored at 1 % (mean) and 3 % (std),
    median of up to 3 fresh draws of both sides (tests/test_tpu_kernels.py)."""
    k_draws, o_draws = [], []
    for attempt in range(attempts):
        k_draws.append(kernel_fn(attempt))
        o_draws.append(oracle_fn(attempt))
        mean_k, std_k = (float(np.median(v)) for v in zip(*k_draws))
        mean_o, std_o = (float(np.median(v)) for v in zip(*o_draws))
        se_mean = std_o * math.sqrt(1.0 / n_kernel + 1.0 / n_oracle)
        se_std = std_o * math.sqrt(0.5 / n_kernel + 0.5 / n_oracle)
        mean_tol = max(6.0 * se_mean, 0.01 * abs(mean_o))
        std_tol = max(6.0 * se_std, 0.03 * std_o)
        line = (f"{label}: kernel mean {mean_k:.4f} std {std_k:.4f} | plain engine mean "
                f"{mean_o:.4f} std {std_o:.4f} | tol {mean_tol:.4f}/{std_tol:.4f} "
                f"(draw {attempt + 1})")
        print(line)
        if abs(mean_k - mean_o) < mean_tol and abs(std_k - std_o) < std_tol:
            return
    raise RuntimeError(f"{label}: statistics disagree after {attempts} draws: {line}")


def mean_std(stats: torch.Tensor, n: int) -> tuple[float, float]:
    s = stats.double()
    mean = float(s[0].sum()) / n
    return mean, math.sqrt(max(float(s[1].sum()) / n - mean * mean, 0.0))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from smart_nanogrid_gym_torch.core import NanogridConfig, SmartNanogridTorch, make_params
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
        actor_weights, gen_policy_day, gen_policy_day_plain, gen_policy_multiday,
        gen_policy_multiday_plain)
    from smart_nanogrid_gym_torch.ops.gen_rollout import (
        gen_rbc_day, gen_rbc_day_plain, gen_rbc_multiday, gen_rbc_multiday_plain, kernel_traces)
    from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policy_at_scale
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic, make_actor_policy_fn
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn
    from smart_nanogrid_gym_torch.utils.weights import load_actor_critic_npz

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain engine's actor in full f32
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    rbc_cfg = NanogridConfig()  # the bench default: 8 chargers, PV + BESS, sparse, 1 h
    art_cfg = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True,
                             penalty_mode="sparse", time_interval=1.0)
    v2x_cfg = NanogridConfig(vehicle_to_everything=True)
    rbc_params = make_params(rbc_cfg, torch.float32, device)
    art_params = make_params(art_cfg, torch.float32, device)
    v2x_params = make_params(v2x_cfg, torch.float32, device)
    artifact = load_actor_critic_npz(ARTIFACT_NPZ).to(device)
    errors, times = {}, {}

    # ---- phase 1: build every kernel from the sources ----
    t0 = time.perf_counter()
    built = _build.build([_build.config_flags(c) for c in (rbc_cfg, art_cfg)])
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s wall; "
          + ", ".join(f"{p.name} {s:.2f} s" for p, s in built))
    for path, _ in built:
        with open(path.with_suffix(".log")) as fp:
            for line in fp:
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())

    # ---- phase 2: K7 against its twin, bench config, B=4096 ----
    u, pv = explicit_inputs(rbc_cfg, BENCH_BATCH, 0, device)
    batt = torch.full_like(pv, 0.5)
    traces = kernel_traces(rbc_params, device)
    errors["gen_rbc_day"] = compare(
        "K7 gen_rbc_day", gen_rbc_day(rbc_cfg, rbc_params, u, pv),
        gen_rbc_day_plain(rbc_cfg, traces, u, pv, batt), rtol=2e-5, atol=1e-5)

    # ---- phase 3: K5 against its twin: the artifact, and a shifted 8-charger v2x actor ----
    u4, pv4 = explicit_inputs(art_cfg, BENCH_BATCH, 1, device)
    art_traces = kernel_traces(art_params, device)
    err_art = compare(
        "K5 gen_policy_day (artifact, 4ch b-pv)", gen_policy_day(art_cfg, art_params, artifact, u4, pv4),
        gen_policy_day_plain(art_cfg, art_traces, actor_weights(art_cfg, artifact, device), u4, pv4,
                             torch.full_like(pv4, 0.5)), rtol=2e-4, atol=2e-4)
    torch.manual_seed(13)
    v2x_actor = ActorCritic(v2x_cfg.obs_dim, v2x_cfg.num_actions)
    with torch.no_grad():
        bias = [0.5 if n % 2 == 0 else -0.4 for n in range(v2x_cfg.num_chargers)] + [-0.3]
        v2x_actor.pi.Dense_2.bias.copy_(torch.tensor(bias))
    v2x_actor = v2x_actor.to(device)
    u8, pv8 = explicit_inputs(v2x_cfg, BENCH_BATCH, 2, device)
    err_v2x = compare(
        "K5 gen_policy_day (shifted actor, 8ch v2x-b-pv)",
        gen_policy_day(v2x_cfg, v2x_params, v2x_actor, u8, pv8),
        gen_policy_day_plain(v2x_cfg, kernel_traces(v2x_params, device),
                             actor_weights(v2x_cfg, v2x_actor, device), u8, pv8,
                             torch.full_like(pv8, 0.5)), rtol=2e-4, atol=2e-4)
    errors["gen_policy_day"] = max(err_art, err_v2x)

    # ---- phase 4: K8 and K6 element for element against their Philox twins ----
    errors["gen_rbc_multiday"] = compare(
        "K8 gen_rbc_multiday (B=1024, 3 days)", (gen_rbc_multiday(rbc_cfg, rbc_params, 3, 11, 1024),),
        (gen_rbc_multiday_plain(rbc_cfg, traces, 3, 11, 1024),), rtol=1e-5, atol=1e-3)
    art_weights = actor_weights(art_cfg, artifact, device)
    errors["gen_policy_multiday"] = compare(
        "K6 gen_policy_multiday (B=1024, 3 days)",
        (gen_policy_multiday(art_cfg, art_params, artifact, 3, 12, 1024),),
        (gen_policy_multiday_plain(art_cfg, art_traces, art_weights, 3, 12, 1024),),
        rtol=2e-4, atol=1e-2)
    torch.cuda.synchronize()

    # ---- the main path, through the entry points a user calls ----
    _build.reset_launch_counts()
    # paired evaluation of the RBC and the artifact on the same explicit days (K7, K5)
    rbc_rewards, _ = gen_rbc_day(art_cfg, art_params, u4, pv4)
    ppo_rewards, actions, _, _ = gen_policy_day(art_cfg, art_params, artifact, u4, pv4)
    # the bench's RBC multiday run (K8), at the bench batch and at a batch that fills the card
    scale = {}
    for batch, days in ((BENCH_BATCH, 2000), (131_072, 100)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = gen_rbc_multiday(rbc_cfg, rbc_params, days, 1000, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        scale[batch] = (stats, days, seconds)
        rate = batch * days * rbc_cfg.steps_per_day / seconds
        print(f"phase 5 K8 at scale: B={batch} x {days} days in {seconds:.4f} s "
              f"(first call, build excluded) = {rate:.4e} env-steps/s on {card}")
    # the artifact at scale through the evaluator (K6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at_scale = evaluate_policy_at_scale(art_cfg, art_params, artifact, num_days=256,
                                        batch=BENCH_BATCH, seed=0)
    seconds = time.perf_counter() - t0
    print(f"phase 6 evaluate_policy_at_scale: {at_scale} in {seconds:.4f} s "
          f"= {at_scale['total_days'] * 24 / seconds:.4e} env-steps/s on {card}")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"main path launches: {launches}")
    for name in REPLACES:
        check(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the main path")

    # ---- what came out is right ----
    for name, x in (("rbc rewards", rbc_rewards), ("ppo rewards", ppo_rewards), ("actions", actions)):
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite")
    check(rbc_rewards.shape == (24, BENCH_BATCH) and actions.shape == (24, 5, BENCH_BATCH),
          "paired day shapes")
    low, high = (torch.as_tensor(b, device=device)[None, :, None] for b in art_cfg.action_bounds())
    check(bool(((actions >= low) & (actions <= high)).all()), "actions outside the action box")
    paired_ppo, paired_rbc = float(ppo_rewards.sum(0).mean()), float(rbc_rewards.sum(0).mean())
    print(f"paired explicit days (B={BENCH_BATCH}): ppo {paired_ppo:.4f}, rbc {paired_rbc:.4f}")
    check(paired_ppo > paired_rbc, "the artifact should beat the RBC on paired days")

    env_rbc = SmartNanogridTorch(rbc_cfg)
    rbc_policy = make_rbc_policy_fn(rbc_cfg)
    oracle_days = 16

    def k8_draw(attempt):
        if attempt == 0:
            stats, days, _ = scale[BENCH_BATCH]
        else:
            days = 2000
            stats = gen_rbc_multiday(rbc_cfg, rbc_params, days, 1000 + attempt, BENCH_BATCH)
        return mean_std(stats, days * BENCH_BATCH)

    def rbc_oracle(attempt):
        gen = torch.Generator(device=device).manual_seed(77 + attempt)
        sums = torch.zeros((), dtype=torch.float64, device=device)
        sq = torch.zeros((), dtype=torch.float64, device=device)
        for _ in range(oracle_days):
            state, obs = env_rbc.reset_batch(rbc_params, BENCH_BATCH, gen)
            _, _, (_, rewards, _, _) = env_rbc.rollout_day(rbc_params, state, rbc_policy, obs, gen)
            ret = rewards.sum(0).double()
            sums, sq = sums + ret.sum(), sq + (ret * ret).sum()
        n = oracle_days * BENCH_BATCH
        mean = float(sums) / n
        return mean, math.sqrt(max(float(sq) / n - mean * mean, 0.0))

    stats_match("phase 5 K8 vs plain engine (RBC, 4096 x 16 fresh days)", k8_draw, rbc_oracle,
                2000 * BENCH_BATCH, oracle_days * BENCH_BATCH)

    art_env = SmartNanogridTorch(art_cfg)
    art_policy = make_actor_policy_fn(art_cfg, artifact)
    k6_days = 256

    def k6_draw(attempt):
        if attempt == 0:
            return at_scale["mean_day_return"], at_scale["std_day_return"]
        res = evaluate_policy_at_scale(art_cfg, art_params, artifact, k6_days, BENCH_BATCH, attempt)
        return res["mean_day_return"], res["std_day_return"]

    def k6_oracle(attempt):
        """Fresh days with the battery carried from one day to the next, as K6 does."""
        gen = torch.Generator(device=device).manual_seed(99 + attempt)
        batt = torch.full((BENCH_BATCH,), 0.5, device=device)
        sums = sq = 0.0
        for _ in range(k6_days):
            state, obs = art_env.reset_batch(art_params, BENCH_BATCH, gen, batt_soc=batt)
            final, _, (_, rewards, _, _) = art_env.rollout_day(art_params, state, art_policy, obs, gen)
            batt = final.batt_soc
            ret = rewards.sum(0).double()
            sums, sq = sums + ret.sum(), sq + (ret * ret).sum()
        n = k6_days * BENCH_BATCH
        mean = float(sums) / n
        return mean, math.sqrt(max(float(sq) / n - mean * mean, 0.0))

    stats_match("phase 6 K6 vs plain engine (artifact, 4096 x 256 days, battery carried)",
                k6_draw, k6_oracle, k6_days * BENCH_BATCH, k6_days * BENCH_BATCH)

    # ---- phase 7: each kernel and its twin, timed on the card ----
    timing_days = 20
    cases = {
        "gen_rbc_day": (f"B={BENCH_BATCH}, 1 day, 8ch b-pv",
                        lambda: gen_rbc_day(rbc_cfg, rbc_params, u, pv),
                        lambda: gen_rbc_day_plain(rbc_cfg, traces, u, pv, batt), 20),
        "gen_rbc_multiday": (f"B={BENCH_BATCH}, {timing_days} days, 8ch b-pv",
                             lambda: gen_rbc_multiday(rbc_cfg, rbc_params, timing_days, 5, BENCH_BATCH),
                             lambda: gen_rbc_multiday_plain(rbc_cfg, traces, timing_days, 5, BENCH_BATCH),
                             5),
        "gen_policy_day": (f"B={BENCH_BATCH}, 1 day, artifact 4ch b-pv",
                           lambda: gen_policy_day(art_cfg, art_params, artifact, u4, pv4),
                           lambda: gen_policy_day_plain(art_cfg, art_traces, art_weights, u4, pv4,
                                                        torch.full_like(pv4, 0.5)), 20),
        "gen_policy_multiday": (f"B={BENCH_BATCH}, {timing_days} days, artifact 4ch b-pv",
                                lambda: gen_policy_multiday(art_cfg, art_params, artifact, timing_days,
                                                            5, BENCH_BATCH),
                                lambda: gen_policy_multiday_plain(art_cfg, art_traces, art_weights,
                                                                  timing_days, 5, BENCH_BATCH), 5),
    }
    for name, (shape, kernel, plain, repeats) in cases.items():
        times[name] = (shape, cuda_ms(kernel, repeats), cuda_ms(plain, 1))
        print(f"phase 7 {name} ({shape}): kernel {times[name][1]:.4f} ms, "
              f"plain twin {times[name][2]:.4f} ms on {card}")

    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
    check(not jax_modules, f"the port loaded JAX modules: {jax_modules[:5]}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": errors[name], "ms": times[name][1],
        "plain_ms": times[name][2], "shape": times[name][0],
    } for name in REPLACES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
