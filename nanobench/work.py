"""The yardstick's arithmetic: the card's peaks, the least time of a piece of
work on them, and the operations, bytes and Philox blocks each measured call
needs.

Everything here is computed from shapes and from the day's draws, never from
the build or from timings, so that it reads the same work whatever
implements it.  The functions are frozen copies of the program's own
arithmetic (``chip_smoke.py``: ``sm_ms``, ``bound``, ``mlp_flops``,
``philox_calls_per_day``, the collection's and the sweep's counts), with the
one input that read the build, a Philox block's lane instructions by pipe,
frozen at the count the built library's SASS gave (``{'fma': 22, 'alu': 19,
'issue': 41}``; NVIDIA H100 80GB HBM3, CUDA 12.8).
"""

from __future__ import annotations

# NVIDIA's published H100 SXM peaks (dense, 700 W): HBM bytes/s, float32
# operations/s outside the tensor cores, bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# The SMs' clocks a second summed over the card: 128 FMA lanes a clock an SM,
# an FMA counted as two operations.
SM_CLOCKS_PER_S = F32_OPS_PER_S / (2 * 128)
# An SM's lanes a clock: each pipe's (the FMA pipe's halves take 64 each,
# IMAD runs on one of them), and the four schedulers' issue.
PIPE_LANES, ISSUE_LANES = 64, 128
# One Philox4x32-10 block's lane instructions by pipe (FMA, integer ALU, issue).
PHILOX_PIPES = {"fma": 22, "alu": 19, "issue": 41}


def sm_ms(n_ops: float, philox_blocks: float = 0.0, pipes: dict | None = None) -> float:
    """The least time in ms the SMs' pipes take for ``n_ops`` f32 operations
    (FMAs on both halves of the FMA pipe) and ``philox_blocks`` Philox blocks
    of ``pipes`` lane instructions each: the busiest of the FMA pipe, its
    IMAD half, the integer ALU and the issue."""
    pipes = pipes or PHILOX_PIPES
    ffma = n_ops / 2
    fma, alu, issue = (philox_blocks * pipes[k] for k in ("fma", "alu", "issue"))
    clocks = max((ffma + fma) / ISSUE_LANES, fma / PIPE_LANES, alu / PIPE_LANES, (ffma + issue) / ISSUE_LANES)
    return clocks / SM_CLOCKS_PER_S * 1e3


def bound(n_bytes: float, n_ops: float, bf16_ops: float = 0.0, philox_blocks: float = 0.0) -> tuple[float, str]:
    """The least time in ms for moving ``n_bytes``, ``n_ops`` f32 operations
    and ``philox_blocks`` Philox blocks on the SMs' pipes, and ``bf16_ops``
    on the tensor cores, and which of bytes or operations bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(sm_ms(n_ops, philox_blocks), bf16_ops / BF16_OPS_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlp_flops(F: int, A: int, H1: int, H2: int) -> int:
    """Operations (a multiply-add is 2) of a 2-hidden-layer torso's forward."""
    return 2 * (H1 * F + H2 * H1 + A * H2)


def day_dims(grid: dict) -> tuple[int, int, int, int]:
    """``(T, N, F, A)`` of a grid of the configuration files: steps a day,
    chargers, observation width and actions."""
    dt = float(grid["time_interval_h"])
    T, N = int(round(24.0 / dt)), int(grid["chargers"])
    pv, batt = bool(grid["pv"]), bool(grid["battery"])
    F = (1 + int(pv)) * (1 + int(grid["lookahead"])) + 2 * N + int(batt)
    return T, N, F, N + int(batt)


def philox_calls_per_day(grid: dict) -> int:
    """Philox blocks of one env-day of generation draws: arrival and SoC
    always, capacity and requested SoC when configured, departure on the
    steps whose window is open, plus the PV-shift draw."""
    T, N, _, _ = day_dims(grid)
    dt = float(grid["time_interval_h"])
    k4, k10, k1 = int(4 / dt), int(10 / dt), int(1 / dt)
    kinds = 2 + int(grid["different_capacities"]) + int(grid["requested_soc"])
    dep_steps = sum(1 for t in range(T) if t + k4 < min(t + k10, T + k1))
    return ((N + 3) // 4) * (kinds * T + dep_steps) + 1


def rbc_days(grid: dict, batch: int, days: int) -> dict:
    """K8's work for ``days`` fresh RBC days of ``batch`` envs: the per-env
    stats written, and the day's Philox blocks (the RBC and the physics are
    not counted)."""
    return {"bytes": 4 * 2 * batch, "ops": 0, "philox": philox_calls_per_day(grid) * days * batch}


def policy_days(grid: dict, hidden: tuple[int, int], batch: int, days: int) -> dict:
    """K6's work: the stats written, the actor's forward each env-step, the
    Philox blocks of the days."""
    T, _, F, A = day_dims(grid)
    return {"bytes": 4 * 3 * batch, "ops": mlp_flops(F, A, *hidden) * T * days * batch,
            "philox": philox_calls_per_day(grid) * days * batch}


def collect_day(grid: dict, hidden: tuple[int, int], batch: int) -> dict:
    """K2's work for one collection day: the trajectory written and the
    battery read, both torsos' forward each env-step, the generation draws,
    the action normals' blocks and the PV-shift block."""
    T, _, F, A = day_dims(grid)
    traj = 4 * (T * F * batch + T * A * batch + 3 * T * batch + batch)
    normal_calls = 2 * ((A + 3) // 4) * T
    return {"bytes": 4 * batch + traj, "ops": (mlp_flops(F, A, *hidden) + mlp_flops(F, 1, *hidden)) * T * batch,
            "philox": (philox_calls_per_day(grid) + normal_calls + 1) * batch}


def sweep(grid: dict, hidden: tuple[int, int], batch: int, epochs: int, minibatches: int) -> dict:
    """K3's work for one update's ``epochs × minibatches`` gradient steps
    over one day of ``batch`` envs: the trajectory read once and the
    parameters and Adam moments read and written; per sample each torso's
    forward and the backward's weight and input gradients."""
    T, _, F, A = day_dims(grid)
    H1, H2 = hidden
    per_sample = mlp_flops(F, A, H1, H2) + mlp_flops(F, 1, H1, H2) + bwd_flops(F, A, H1, H2) + bwd_flops(F, 1, H1, H2)
    P = param_count(F, A, H1, H2)
    G, M = epochs * minibatches, (batch // minibatches) * T
    state_bytes = 4 * 3 * P * 2 + 4 * 4 * G
    return {"bytes": 4 * T * batch * (F + A + 3) + state_bytes, "ops": per_sample * G * M, "philox": 0}


def bwd_flops(F: int, A: int, H1: int, H2: int) -> int:
    """Operations of a torso's backward per sample: the weight gradients of
    the three layers and the input gradients through W3 and W2."""
    return 2 * (H1 * F + 2 * H1 * H2 + 2 * A * H2)


def param_count(F: int, A: int, H1: int, H2: int) -> int:
    """Parameters of the actor-critic: two torsos and the log-std."""
    torso = lambda out: H1 * F + H1 + H2 * H1 + H2 + out * H2 + out  # noqa: E731
    return torso(A) + torso(1) + A


def least_ms(work: dict) -> float:
    """The least time in ms of ``work`` (``bytes``, ``ops``, ``philox``)."""
    return bound(work["bytes"], work["ops"], 0.0, work["philox"])[0]
