"""Device time of the PPO or DDPG training path by kernel, on one CUDA card.

Run from the root of the repository (it builds the kernels first):

    python3 -m smart_nanogrid_gym_torch.tools.profile_train [--batch 4096] [--updates 5] [--ddpg] [--bf16]

Trains ``PPOLearner(collect_impl="kernel", sweep_impl="kernel")`` (with
``--ddpg``: ``DDPGLearner(collect_impl="kernel", sweep_impl="kernel")``) on the
8-charger bench config (with ``--bf16``: ``update_matmul_dtype=torch.bfloat16``)
for two warm-up updates, then profiles ``--updates`` updates with
``torch.profiler`` and prints, per kernel name, the launches and the device
milliseconds per update; the device busy share of the window (summed
device-event time over the profiled wall time; kernels that overlap would
count twice, so it is an upper bound); the host-clock milliseconds per
update; and the milliseconds per update in which the card ran no kernel
(wall minus device time: the host work the card waits on).  The last line is
one JSON object with the same numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

KERNELS = {  # substring of the CUDA kernel's name -> the port's kernel
    "ppo_collect_day_kernel": "K2 ppo_collect_day_seeded",
    "gae_kernel": "GAE gae_kernel",
    "ppo_sweep_kernel": "K3 ppo_sweep_kernel",
    "ddpg_collect_day_kernel": "K9 ddpg_collect_day_seeded",
    "ddpg_sweep_kernel": "K10 ddpg_sweep_kernel",
}


def device_by_kernel(prof) -> tuple[dict[str, list[float]], float]:
    """Launches and device milliseconds by kernel, and the device microseconds
    in all, of a finished ``torch.profiler`` run.  Device-side events only (a
    CPU op's self device time repeats its kernels'), less the user
    annotations: a ``record_function`` (the port's ``ng.`` spans) also writes
    one on the device's timeline, whose device time is the span's length."""
    per_kernel: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    device_total = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.is_user_annotation:
            continue
        device_us = evt.self_device_time_total
        if device_us <= 0:
            continue
        device_total += device_us
        name = next((label for key, label in KERNELS.items() if key in evt.key), "other: " + evt.key[:60])
        per_kernel[name][0] += evt.count
        per_kernel[name][1] += device_us / 1e3
    return per_kernel, device_total


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--updates", type=int, default=5)
    parser.add_argument("--ddpg", action="store_true", help="profile the DDPG learner (K9 + K10)")
    parser.add_argument("--bf16", action="store_true", help="update_matmul_dtype=torch.bfloat16")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    from smart_nanogrid_gym_torch.core import NanogridConfig, make_params
    from smart_nanogrid_gym_torch.solvers.ddpg import DDPGConfig, DDPGLearner
    from smart_nanogrid_gym_torch.solvers.ppo import PPOConfig, PPOLearner

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    config = NanogridConfig()
    params = make_params(config)
    kw = dict(collect_impl="kernel", sweep_impl="kernel", update_matmul_dtype=torch.bfloat16 if args.bf16 else None)
    learner = DDPGLearner(config, DDPGConfig(**kw)) if args.ddpg else PPOLearner(config, PPOConfig(**kw))
    state = learner.init(0, params, args.batch)
    step = learner.build_train_step()
    for _ in range(2):
        state, _ = step(state, params)
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.updates):
            state, metrics = step(state, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_kernel, device_total = device_by_kernel(prof)
    n = args.updates
    print(f"card: {card}")
    idle_ms = max(wall * 1e3 - device_total / 1e3, 0.0) / n
    print(f"{n} updates x B={args.batch}: wall {wall * 1e3 / n:.4f} ms/update (host clock), "
          f"device {device_total / 1e3 / n:.4f} ms/update, busy share {device_total / 1e6 / wall:.4f}, "
          f"card idle {idle_ms:.4f} ms/update")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    for name, (count, ms) in rows:
        print(f"  {name}: {count / n:.1f} launches/update, {ms / n:.4f} device ms/update, "
              f"{ms / max(count, 1):.4f} ms/launch")
    print(json.dumps({"card": card, "learner": "ddpg" if args.ddpg else "ppo", "bf16": args.bf16,
                      "batch": args.batch, "updates": n,
                      "wall_ms_per_update": wall * 1e3 / n,
                      "device_ms_per_update": device_total / 1e3 / n, "idle_ms_per_update": idle_ms,
                      "kernels": {k: {"launches_per_update": c / n, "device_ms_per_update": ms / n}
                                  for k, (c, ms) in rows},
                      "mean_return": float(metrics.mean_return)}))


if __name__ == "__main__":
    main()
