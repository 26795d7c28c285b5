"""The port's bench: env-steps/s of the PyTorch/CUDA port on one card.

The counterpart of the root ``bench.py`` (the JAX package's bench, which it
leaves as it is).  Every row runs on the 8-charger bench config (PV + BESS,
sparse penalties, 1 h; the reference's constructor defaults) at B=4096
through the port's entry points:

- the headline: K8 (``ops/gen_rollout.py::gen_rbc_multiday``: day generation
  from the in-kernel Philox, the RBC and the physics, one launch per
  400,000 days), its day-return statistics first held against the plain
  engine (:func:`check_multiday_stats`), then timed over three calls;
- ``--all``: the fourteen rows of the JAX bench's table under its keys
  (:func:`bench_all`), each timed as one warm call and three timed calls;
- ``--scaling``: ``parallel/distributed.py::scaling_sweep`` on K8 in the
  world the process runs in, and the plain engine on 8 gloo ranks on the
  CPU (a child ``torchrun``, tagged ``virtual``);
- ``--train-profile``: the plain PPO update's phases by CUDA events, and
  the kernel path's update (K2 + K3).

Times are the host clock around calls that end in ``torch.cuda.synchronize``,
the user's wall clock.  Nothing falls back: a kernel, a launch or the
statistical gate that fails ends the run with a non-zero exit.  Every output
names the card (``nvidia-smi`` name and power limit).  The outputs are
``BENCH_TABLE_torch.json``, ``SCALING_torch.json`` and
``TRAIN_PROFILE_torch.json`` at the repository root; the JAX bench's files
are never written.

Run on a machine with a card (``--device cuda``, the default, raises
without one; ``--device cpu`` runs the kernels' plain twins, for tests):

    python -m smart_nanogrid_gym_torch.tools.bench [--all | --scaling | --train-profile]

Prints one JSON line: ``{"metric", "value", "unit", "vs_baseline", "card"}``
(``--all``: one line per row; ``--scaling``: one per platform;
``--train-profile``: the report).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..core.config import NanogridConfig
from ..core.generate import generate_schedule
from ..core.params import NanogridParams, broadcast_params, make_params
from ..core.rollout import fused_day_rollout
from ..core.transition import reset
from ..solvers.rbc import make_rbc_policy_fn

# the reference's pure-Python env on a CPU: one env, 8 chargers b-pv, its
# per-episode day generation and JSON dumps included (the root bench.py's
# docstring); the baseline of ``vs_baseline``, not a card's figure
REFERENCE_STEPS_PER_SEC = 1699.0

BATCH = 4096
NUM_CALLS_TIMED = 3
HEADLINE_DAYS = 400_000
HEADLINE_SEED = 50_000  # the gate's draws; the timed calls use seeds 0, 1, 2
ORACLE_DAYS = 50  # the plain engine's days a draw of the gate
TRAIN_PROFILE_REPS = 25
CONFIG_LABEL = "8ch b-pv sparse 1h"
UNIT = "env-steps/s"
METRIC = "env_steps_per_sec_per_chip_4096envs"

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the outputs; a relative path is taken from the repository root
TABLE_PATH = "BENCH_TABLE_torch.json"
SCALING_PATH = "SCALING_torch.json"
TRAIN_PROFILE_PATH = "TRAIN_PROFILE_torch.json"

# days (or updates, or host steps) a call of each bench_all row, the root
# bench.py's numbers; the rows run in this order, the JAX table's
ROW_DEPTH = {
    "pallas_gen_rbc_multiday": 40_000,
    "xla_gen_plus_fused_day": 50,
    "xla_gen_plus_pallas_rbc_day": 50,
    "xla_policy_in_loop": 50,
    "pallas_gen_policy_multiday": 2_500,
    "pallas_gen_policy_multiday_256x256_f32": 1_000,
    "pallas_gen_policy_multiday_256x256_bf16": 1_000,
    "ppo_train_update": 25,
    "ppo_train_update_unamortized": 1,
    "ppo_train_update_kernel": 25,
    "ddpg_train_update": 25,
    "ddpg_train_update_kernel": 25,
    "native_single_env": 20_000,
    "native_batched_1024": 240,
}
NATIVE_ENVS = 1024
VIRTUAL_RANKS = 8  # the plain engine's gloo ranks of the cpu_virtual scaling record
VIRTUAL_FLAG = "--virtual-rank"


def bench_config() -> NanogridConfig:
    return NanogridConfig(num_chargers=8, pv_system=True, battery_system=True, penalty_mode="sparse",
                          time_interval=1.0)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device: torch.device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it, or
    ``cpu`` for a run on the CPU (the twins; no card's figure)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def torch_line() -> str:
    return f"{torch.__version__} cuda {torch.version.cuda}"


def write_json(payload: dict, out_path: str) -> None:
    """``payload`` as indented JSON at ``out_path`` (relative to the
    repository root)."""
    with open(os.path.join(ROOT, out_path), "w") as fp:
        json.dump(payload, fp, indent=2)
        fp.write("\n")


# ------------------------------------------------------- the statistical gate --

def mean_std(stats: torch.Tensor, n: int) -> tuple[float, float]:
    """Mean and std of the day returns from a multiday kernel's ``(Σ, Σ²)``
    rows per env, reduced in f64 on the host."""
    s = stats.double()
    mean = float(s[0].sum()) / n
    return mean, math.sqrt(max(float(s[1].sum()) / n - mean * mean, 0.0))


def plain_day_return_stats(config: NanogridConfig, params: NanogridParams, batch: int, num_calls: int,
                           seed0: int = 1000, days_per_call: int = ORACLE_DAYS) -> tuple[float, float, int]:
    """Day-return mean and std from the plain engine: a fresh generated day
    (``generate_schedule`` + ``reset``) rolled by ``fused_day_rollout`` under
    the RBC, ``num_calls`` × ``days_per_call`` days × ``batch`` envs on the
    device of ``params``, summed in f64: the oracle the multiday kernels'
    in-kernel draws are held against (the root bench.py's
    ``xla_day_return_stats``).  Returns ``(mean, std, n)``."""
    device = params.device
    policy = make_rbc_policy_fn(config)
    total = torch.zeros((), dtype=torch.float64, device=device)
    total_sq = torch.zeros((), dtype=torch.float64, device=device)
    for i in range(num_calls):
        gen = torch.Generator(device=device).manual_seed(seed0 + i)
        for _ in range(days_per_call):
            state, _ = reset(config, params, generate_schedule(config, params, generator=gen, batch=batch),
                             generator=gen)
            _, (_, rewards, _) = fused_day_rollout(config, params, state, policy, generator=gen)
            ret = rewards.sum(0).double()
            total, total_sq = total + ret.sum(), total_sq + (ret * ret).sum()
    n = num_calls * days_per_call * batch
    mean = float(total) / n
    return mean, math.sqrt(max(float(total_sq) / n - mean * mean, 0.0)), n


def stats_bounds(ref_mean: float, ref_std: float, n_kernel: int, n_oracle: int,
                 z: float = 6.0) -> tuple[float, float]:
    """Tolerances ``(mean_tol, std_tol)`` of the kernel-against-oracle
    day-return check: ``z`` standard errors of the difference of two
    independent sample means, ``σ·sqrt(1/n_k + 1/n_o)``, and of two sample
    stds (normal theory), ``σ·sqrt(1/(2n_k) + 1/(2n_o))``, floored at 1 % of
    the mean and 3 % of the std (day returns are penalty-heavy-tailed, so the
    normal-theory error is a lower bound)."""
    se_mean = ref_std * (1.0 / n_kernel + 1.0 / n_oracle) ** 0.5
    se_std = ref_std * (0.5 / n_kernel + 0.5 / n_oracle) ** 0.5
    return max(z * se_mean, 0.01 * abs(ref_mean)), max(z * se_std, 0.03 * ref_std)


def check_multiday_stats(kernel_stats_fn, n_kernel: int, config: NanogridConfig | None,
                         params: NanogridParams | None, label: str, max_attempts: int = 3, *,
                         batch: int = BATCH, oracle_days: int = ORACLE_DAYS, oracle_fn=None,
                         n_oracle: int | None = None) -> tuple[float, float]:
    """Hold a kernel's day-return statistics against an oracle within
    :func:`stats_bounds`, by the median of up to ``max_attempts`` draws.

    ``kernel_stats_fn(attempt) -> (mean, std)`` draws with a fresh seed each
    attempt.  The oracle is ``oracle_fn(attempt) -> (mean, std)`` over
    ``n_oracle`` day returns, by default :func:`plain_day_return_stats` of
    ``config`` and ``params`` (``oracle_days`` days × ``batch``, seed ``1000 +
    100·attempt``).  Attempt 1 compares one draw of each; after a miss both
    sides draw again and the medians are compared, so a real distribution
    fault fails every draw while a tail cannot survive the median.  Prints
    each draw to standard error; returns the oracle's ``(mean, std)`` and
    raises ``AssertionError`` after the last miss."""
    if oracle_fn is None:
        def oracle_fn(attempt):
            return plain_day_return_stats(config, params, batch, 1, seed0=1000 + 100 * attempt,
                                          days_per_call=oracle_days)[:2]

        n_oracle = oracle_days * batch
    k_draws, o_draws = [], []
    for attempt in range(max_attempts):
        k_draws.append(kernel_stats_fn(attempt))
        o_draws.append(oracle_fn(attempt))
        mean, std = (float(np.median(v)) for v in zip(*k_draws))
        ref_mean, ref_std = (float(np.median(v)) for v in zip(*o_draws))
        mean_tol, std_tol = stats_bounds(ref_mean, ref_std, n_kernel, n_oracle)
        line = (f"{label}: kernel mean {mean:.4f} std {std:.4f} | plain engine mean {ref_mean:.4f} std "
                f"{ref_std:.4f} | tol {mean_tol:.4f}/{std_tol:.4f} (draw {attempt + 1} of {max_attempts})")
        print(f"# {line}", file=sys.stderr)
        if abs(mean - ref_mean) < mean_tol and abs(std - ref_std) < std_tol:
            return ref_mean, ref_std
    raise AssertionError(f"{label}: day-return statistics disagree with the oracle after {max_attempts} "
                         f"median-combined draws: {line}")


# ------------------------------------------------------------- the headline --

def bench_headline(config: NanogridConfig, params: NanogridParams, batch: int = BATCH,
                   days: int = HEADLINE_DAYS, calls: int = NUM_CALLS_TIMED) -> float:
    """K8's env-steps/s: ``days`` fresh RBC days × ``batch`` envs a launch,
    after its statistics passed :func:`check_multiday_stats` (seeds
    ``HEADLINE_SEED + attempt``), over ``calls`` timed launches (seeds 0, 1,
    ...) by the host clock around ``torch.cuda.synchronize``."""
    from ..ops.gen_rollout import gen_rbc_multiday

    def kernel_stats(attempt):
        return mean_std(gen_rbc_multiday(config, params, days, HEADLINE_SEED + attempt, batch), days * batch)

    check_multiday_stats(kernel_stats, days * batch, config, params, "gen_rbc_multiday", batch=batch)
    synchronize(params.device)
    t0 = time.perf_counter()
    for i in range(calls):
        gen_rbc_multiday(config, params, days, i, batch)
    synchronize(params.device)
    return batch * config.steps_per_day * days * calls / (time.perf_counter() - t0)


def headline_line(steps_per_sec: float, card: str) -> dict:
    return {"metric": METRIC, "value": round(steps_per_sec, 1), "unit": UNIT,
            "vs_baseline": round(steps_per_sec / REFERENCE_STEPS_PER_SEC, 2), "card": card}


# --------------------------------------------------------------- bench_all --

def timeit(fn, work_steps: int, device: torch.device, calls: int = NUM_CALLS_TIMED) -> float:
    """``work_steps`` env-steps a call of ``fn(i)``: one warm call, then
    ``calls`` calls by the host clock, synchronised; returns env-steps/s."""
    fn(0)
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i + 1)
    synchronize(device)
    return work_steps * calls / (time.perf_counter() - t0)


def plain_day_loop(config: NanogridConfig, params: NanogridParams, batch: int, days: int, day_fn):
    """A call of a plain-engine row: ``days`` fresh days of ``batch`` envs,
    each generated and reset by the plain engine (generator seeded by the
    call's index) and rolled by ``day_fn(state, generator) -> rewards (T, B)``;
    the mean day return stays on the device."""

    def call(i):
        gen = torch.Generator(device=params.device).manual_seed(997 * i)
        total = torch.zeros((), dtype=torch.float32, device=params.device)
        for _ in range(days):
            state, _ = reset(config, params, generate_schedule(config, params, generator=gen, batch=batch),
                             generator=gen)
            total = total + day_fn(state, gen).sum(0).mean()
        return total / days

    return call


def bench_all(config: NanogridConfig, params: NanogridParams, batch: int = BATCH, depth: dict | None = None,
              calls: int = NUM_CALLS_TIMED, out_path: str | None = TABLE_PATH) -> dict:
    """Every row of the JAX bench's table on the port, in its order and
    under its keys: env-steps/s by :func:`timeit`, ``depth`` (days, updates
    or host steps a call) overriding :data:`ROW_DEPTH` row by row.  Writes
    ``{"batch", "config", "unit", "card", "torch", "paths"}`` to ``out_path``
    (relative to the repository root; None writes nothing), prints a line a
    row and returns the payload.  The plain rows run their actors' products
    in f32 (TF32 off), as JAX's do."""
    from ..native import NativeBatchEngine, NativeEngine, generate_schedule_native
    from ..ops.gen_policy_rollout import gen_policy_multiday
    from ..ops.gen_rollout import gen_rbc_multiday
    from ..ops.rollout import rbc_day_rollout
    from ..solvers.ddpg import DDPGConfig, DDPGLearner
    from ..solvers.networks import ActorCritic, make_actor_policy_fn
    from ..solvers.ppo import PPOConfig, PPOLearner

    depth = {**ROW_DEPTH, **(depth or {})}
    device = params.device
    T = config.steps_per_day
    day_steps = batch * T
    results = {}
    torch.backends.cuda.matmul.allow_tf32 = False

    def record(key, steps_per_sec):
        results[key] = steps_per_sec
        print(json.dumps({"path": key, "steps_per_sec": round(steps_per_sec, 1)}), flush=True)

    def row(key, fn, work_steps):
        record(key, timeit(fn, work_steps, device, calls))

    # K8: generation, the RBC and the physics in one launch
    days = depth["pallas_gen_rbc_multiday"]
    row("pallas_gen_rbc_multiday", lambda i: gen_rbc_multiday(config, params, days, i, batch), day_steps * days)

    # the plain engine's generation + reset + fused day under the RBC
    rbc = make_rbc_policy_fn(config)
    days = depth["xla_gen_plus_fused_day"]
    row("xla_gen_plus_fused_day", plain_day_loop(
        config, params, batch, days,
        lambda state, gen: fused_day_rollout(config, params, state, rbc, generator=gen)[1][1]),
        day_steps * days)

    # the plain generation + reset, the day by K11a; params batched as the JAX bench passes them
    bparams = broadcast_params(params, batch)
    days = depth["xla_gen_plus_pallas_rbc_day"]
    row("xla_gen_plus_pallas_rbc_day", plain_day_loop(
        config, bparams, batch, days, lambda state, gen: rbc_day_rollout(config, bparams, state)[0]),
        day_steps * days)

    # the plain day with the 64x64 actor's clipped mean
    net = ActorCritic(config.obs_dim, config.num_actions, generator=torch.Generator().manual_seed(0)).to(device)
    actor = make_actor_policy_fn(config, net)
    days = depth["xla_policy_in_loop"]
    row("xla_policy_in_loop", plain_day_loop(
        config, params, batch, days,
        lambda state, gen: fused_day_rollout(config, params, state, actor, generator=gen)[1][1]),
        day_steps * days)

    # K6: generation, the actor and the physics in one launch, the 64x64 and 256x256 torsos
    days = depth["pallas_gen_policy_multiday"]
    row("pallas_gen_policy_multiday", lambda i: gen_policy_multiday(config, params, net, days, i, batch),
        day_steps * days)
    big = ActorCritic(config.obs_dim, config.num_actions, (256, 256),
                      generator=torch.Generator().manual_seed(0)).to(device)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        key = f"pallas_gen_policy_multiday_256x256_{tag}"
        days = depth[key]
        row(key, lambda i, d=days, t=dtype: gen_policy_multiday(config, params, big, d, i, batch, mlp_dtype=t),
            day_steps * days)

    # PPO training: plain (updates_per_call updates a call, and one), and K2 + K3
    for key, ppo in (("ppo_train_update", PPOConfig()), ("ppo_train_update_unamortized", PPOConfig()),
                     ("ppo_train_update_kernel", PPOConfig(collect_impl="kernel", sweep_impl="kernel"))):
        learner = PPOLearner(config, ppo, device=device)
        state = learner.init(0, params, batch)
        updates = depth[key]
        train = learner.build_train_many(updates)
        row(key, lambda i, f=train, s=state: f(s, params), day_steps * updates)
        del learner, state, train

    # DDPG training: plain, and K9 seeded + K10 with bf16 products
    for key, ddpg in (("ddpg_train_update", DDPGConfig(buffer_days=10)),
                      ("ddpg_train_update_kernel", DDPGConfig(buffer_days=10, collect_impl="kernel",
                                                              sweep_impl="kernel",
                                                              update_matmul_dtype=torch.bfloat16))):
        learner = DDPGLearner(config, ddpg, device=device)
        state = learner.init(1, params, batch)
        updates = depth[key]
        train = learner.build_train_many(updates)
        row(key, lambda i, f=train, s=state: f(s, params), day_steps * updates)
        del learner, state, train  # free the replay buffer

    # the native engines on the host
    engine = NativeEngine(config)
    engine.reset(generate_schedule_native(0, config.num_chargers, config.time_interval), batt_soc=0.5)
    action = np.full(config.num_actions, 0.3)
    steps = depth["native_single_env"]
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step(action)
    record("native_single_env", steps / (time.perf_counter() - t0))
    fleet = NativeBatchEngine(config, NATIVE_ENVS)
    fleet.reset([generate_schedule_native(i, config.num_chargers, config.time_interval)
                 for i in range(NATIVE_ENVS)])
    actions = np.broadcast_to(action, (NATIVE_ENVS, config.num_actions)).copy()
    for _ in range(T):
        fleet.step_batch(actions)
    steps = depth["native_batched_1024"]
    t0 = time.perf_counter()
    for _ in range(steps):
        fleet.step_batch(actions)
    record("native_batched_1024", NATIVE_ENVS * steps / (time.perf_counter() - t0))

    payload = {"batch": batch, "config": CONFIG_LABEL, "unit": UNIT, "card": card_line(device),
               "torch": torch_line(), "paths": {k: round(v, 1) for k, v in results.items()}}
    if out_path:
        write_json(payload, out_path)
    return payload


# ----------------------------------------------------------------- scaling --

def free_port() -> int:
    """A TCP port on localhost that was free a moment ago (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(argv: list[str], nproc: int, timeout_s: float, env: dict) -> str:
    """``torchrun --nproc-per-node nproc argv`` on a free localhost port from
    the repository root; returns the ranks' merged output.  torchrun stops
    every rank when one fails, and when it is stopped itself at the time
    limit; either raises ``RuntimeError``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc), "--master-addr",
           "localhost", "--master-port", str(free_port()), "--monitor-interval", "0.1", *argv]
    proc = subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, **env}, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.terminate()  # torchrun stops its ranks on SIGTERM
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        raise RuntimeError(f"torchrun timed out after {timeout_s} s:\n{out[-4000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun exited with {proc.returncode}:\n{out[-4000:]}")
    return out


def virtual_rank(batch_per_device: int, num_days: int) -> None:
    """One gloo rank of the ``cpu_virtual`` record: ``scaling_sweep`` of the
    plain engine on the CPU; rank 0 prints the records."""
    from ..parallel.distributed import initialize_distributed, scaling_sweep
    from ..parallel.mesh import make_mesh

    rank, _ = initialize_distributed(backend="gloo")
    config = bench_config()
    records = scaling_sweep(config, make_params(config, torch.float32, "cpu"), make_mesh("cpu"),
                            batch_per_device=batch_per_device, num_days=num_days, path="plain")
    if rank == 0:
        print("SCALING_RECORDS=" + json.dumps(records), flush=True)
    # gloo's threads left running at exit can abort the rank ("terminate called
    # without an active exception")
    torch.distributed.destroy_process_group()


def virtual_scaling_records(ranks: int = VIRTUAL_RANKS, batch_per_device: int = 256,
                            num_days: int = 4) -> list[dict]:
    """``scaling_sweep(path="plain")`` on ``ranks`` gloo processes on the CPU
    (a child ``torchrun``, the card hidden from it): its ranks share the
    host's cores, so the record checks the multi-process machinery, not
    hardware scaling."""
    out = torchrun(["-m", "smart_nanogrid_gym_torch.tools.bench", VIRTUAL_FLAG, str(batch_per_device),
                    str(num_days)], ranks, timeout_s=1200, env={"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    lines = [line for line in out.splitlines() if line.startswith("SCALING_RECORDS=")]
    if not lines:
        raise RuntimeError(f"the cpu_virtual scaling run printed no records:\n{out[-4000:]}")
    return json.loads(lines[-1].split("=", 1)[1])


def bench_scaling(config: NanogridConfig, params: NanogridParams, batch_per_device: int = BATCH,
                  num_days: int = 100_000, virtual_ranks: int = VIRTUAL_RANKS,
                  out_path: str | None = SCALING_PATH) -> dict:
    """The scaling records: ``scaling_sweep(path="kernel")`` (K8 on each rank)
    in the world this process runs in (``initialize_distributed``; one rank
    outside a launcher, and under torchrun rank 0 reports), and with ``virtual_ranks`` the plain engine on that
    many gloo ranks on the CPU (:func:`virtual_scaling_records`, tagged
    ``virtual``).  Writes them through ``write_scaling_report`` (unless
    ``out_path`` is None), prints a line a platform and returns the payload."""
    from ..parallel.distributed import initialize_distributed, scaling_sweep, write_scaling_report
    from ..parallel.mesh import make_mesh

    rank, _ = initialize_distributed()
    device = params.device
    records = scaling_sweep(config, params, make_mesh(device), batch_per_device=batch_per_device,
                            num_days=num_days, path="kernel")
    card = card_line(device)
    platforms = {device.type: {"records": records, "virtual": False, "card": card}}
    meta = {"platforms": platforms, "card": card, "torch": torch_line()}
    if rank != 0:  # the records are equal on every rank; rank 0 reports them
        return {"records": records, **meta}
    print(json.dumps({"platform": device.type, "records": records, "card": card}), flush=True)
    if virtual_ranks:
        virtual = virtual_scaling_records(virtual_ranks)
        platforms["cpu_virtual"] = {"records": virtual, "virtual": True}
        print(json.dumps({"platform": "cpu_virtual", "records": virtual}), flush=True)
    if out_path:
        write_scaling_report(records, os.path.join(ROOT, out_path), meta)
    return {"records": records, **meta}


# ----------------------------------------------------------- train profile --

class PhaseTimes:
    """Wraps methods of a learner so that each call is bracketed by CUDA
    events on the card (the host clock on the CPU) and its time summed by
    phase; ``seconds()`` synchronises and reads them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: dict[str, list] = {}

    def wrap(self, obj, method: str, phase: str) -> None:
        fn = getattr(obj, method)
        marks = self.marks.setdefault(phase, [])
        cuda = self.device.type == "cuda"

        def timed(*args, **kwargs):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                start = time.perf_counter()
            out = fn(*args, **kwargs)
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            else:
                end = time.perf_counter()
            marks.append((start, end))
            return out

        setattr(obj, method, timed)

    def reset(self) -> None:
        for marks in self.marks.values():
            marks.clear()

    def seconds(self) -> dict[str, float]:
        synchronize(self.device)
        if self.device.type == "cuda":
            return {p: sum(s.elapsed_time(e) for s, e in m) / 1e3 for p, m in self.marks.items()}
        return {p: sum(e - s for s, e in m) for p, m in self.marks.items()}


def bench_train_profile(config: NanogridConfig, params: NanogridParams, batch: int = BATCH,
                        reps: int = TRAIN_PROFILE_REPS, calls: int = NUM_CALLS_TIMED,
                        out_path: str | None = TRAIN_PROFILE_PATH) -> dict:
    """The PPO update's phases at ``batch`` envs, the root bench.py's
    ``TRAIN_PROFILE.json`` keys: the plain learner's collection
    (``_rollout``), GAE (``_gae``) and 10-epoch × 4-minibatch sweep
    (``_sweep``), each by CUDA events around the learner's own call (torch
    runs eagerly: no program to subtract), the whole update (``total``, its
    host draws and reshapes included) and the kernel path's (K2 + K3) by the
    host clock, over ``calls`` calls of ``reps`` updates after a warm call,
    each from the same state.  Writes the report (unless ``out_path`` is
    None), prints it and returns it."""
    from ..solvers.ppo import PPOConfig, PPOLearner

    device = params.device
    torch.backends.cuda.matmul.allow_tf32 = False
    steps = batch * config.steps_per_day * reps
    learner = PPOLearner(config, PPOConfig(), device=device)
    state = learner.init(0, params, batch)
    phases = PhaseTimes(device)
    for method, phase in (("_rollout", "rollout"), ("_gae", "gae"), ("_sweep", "update_sweep_10ep_x_4mb")):
        phases.wrap(learner, method, phase)
    full = learner.build_train_many(reps)

    def timed(fn):
        fn()
        synchronize(device)
        phases.reset()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        synchronize(device)
        return (time.perf_counter() - t0) / calls

    t_full = timed(lambda: full(state, params))
    per_update = {p: s / (calls * reps) for p, s in phases.seconds().items()}
    kernel = PPOLearner(config, PPOConfig(collect_impl="kernel", sweep_impl="kernel"), device=device)
    kstate = kernel.init(0, params, batch)
    kfull = kernel.build_train_many(reps)
    t_kernel = timed(lambda: kfull(kstate, params))
    report = {
        "batch": batch,
        "updates_per_call": reps,
        "env_steps_per_call": steps,
        "phases_sec_per_update": {
            "rollout": round(per_update["rollout"], 6),
            "gae": round(per_update["gae"], 6),
            "update_sweep_10ep_x_4mb": round(per_update["update_sweep_10ep_x_4mb"], 6),
            "total": round(t_full / reps, 6),
        },
        "kernel_path_sec_per_update": round(t_kernel / reps, 6),
        "train_env_steps_per_sec": round(steps / t_full, 1),
        "kernel_train_env_steps_per_sec": round(steps / t_kernel, 1),
        "card": card_line(device),
        "torch": torch_line(),
    }
    if out_path:
        write_json(report, out_path)
    print(json.dumps(report))
    return report


# --------------------------------------------------------------------- CLI --

def main(argv: list[str] | None = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == [VIRTUAL_FLAG]:
        return virtual_rank(int(argv[1]), int(argv[2]))
    from .train_ppo import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--all", action="store_true", help="every row of the table, into BENCH_TABLE_torch.json")
    mode.add_argument("--scaling", action="store_true", help="the scaling records, into SCALING_torch.json")
    mode.add_argument("--train-profile", action="store_true",
                      help="the PPO update's phases, into TRAIN_PROFILE_torch.json")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:  # this rank's card under torchrun
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    config = bench_config()
    params = make_params(config, torch.float32, device)
    if args.all:
        return bench_all(config, params)
    if args.scaling:
        return bench_scaling(config, params)
    if args.train_profile:
        return bench_train_profile(config, params)
    line = headline_line(bench_headline(config, params), card_line(device))
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
