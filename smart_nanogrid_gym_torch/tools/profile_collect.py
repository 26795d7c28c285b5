"""Device time of the collection kernels K1, K2, K9 and K9 seeded on one CUDA card.

Run from the root of a checkout (it builds the kernels first):

    python3 smart_nanogrid_gym_torch/tools/profile_collect.py [--root DIR]

``--root`` imports ``smart_nanogrid_gym_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that one call can time
two versions in turn on the same card; by default the checkout that holds this
file.  On the 8-charger bench config at the bench batch, with seeded random
inputs and networks (the 64x64 actor-critic, the 400-300 DDPG actor), it calls
each wrapper once to warm up, then prints per kernel the device milliseconds
per launch by ``torch.profiler`` over 10 launches and the wrapper's
host milliseconds per call over 20 calls made without synchronising.  The last
line is one JSON object with the numbers, the card's name and power limit, and
the root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BATCH = 4096  # the bench batch
REPEATS = 10  # launches under the profiler


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = parser.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_collect needs a CUDA device")
    from smart_nanogrid_gym_torch.core import NanogridConfig, make_params
    from smart_nanogrid_gym_torch.ops.collect import ppo_collect_day, ppo_collect_day_seeded
    from smart_nanogrid_gym_torch.ops.ddpg_collect import ddpg_collect_day, ddpg_collect_day_seeded
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic, DDPGActor, actor_critic_leaves, ddpg_leaves

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg, B = NanogridConfig(), BATCH
    T, N, A = cfg.steps_per_day, cfg.num_chargers, cfg.num_actions
    params = make_params(cfg, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand((T, 5, N, B), generator=gen, device=dev)
    pv = torch.rand(B, generator=gen, device=dev) * 1.8
    normals = torch.randn((T, A, B), generator=gen, device=dev)
    batt = torch.rand(B, generator=gen, device=dev)
    ou = 0.3 * torch.randn((T, A, B), generator=gen, device=dev)
    ppo = [x.detach().to(dev) for x in actor_critic_leaves(
        ActorCritic(cfg.obs_dim, A, generator=torch.Generator().manual_seed(1)))]
    low, high = cfg.action_bounds()
    ddpg = [x.detach().to(dev) for x in ddpg_leaves(
        DDPGActor(cfg.obs_dim, A, low, high, generator=torch.Generator().manual_seed(2)))]
    cases = {
        "K1 ppo_collect_day": (lambda: ppo_collect_day(cfg, params, ppo, u, normals, pv, batt),
                               "ppo_collect_day_kernel"),
        "K2 ppo_collect_day_seeded": (lambda: ppo_collect_day_seeded(cfg, params, ppo, 5, batt, B),
                                      "ppo_collect_day_kernel"),
        "K9 ddpg_collect_day": (lambda: ddpg_collect_day(cfg, params, ddpg, u, ou, pv, batt),
                                "ddpg_collect_day_kernel"),
        "K9 ddpg_collect_day_seeded": (lambda: ddpg_collect_day_seeded(cfg, params, ddpg, 5, ou, batt, B),
                                       "ddpg_collect_day_kernel"),
    }
    print(f"card: {card}; package from {root}")
    result = {}
    for name, (call, kernel) in cases.items():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPEATS):
                call()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
        if device_us <= 0:
            raise RuntimeError(f"the profiler recorded no device time for {kernel}")
        result[name] = {"device_ms": device_us / REPEATS / 1e3, "host_ms_per_call": host_ms}
        print(f"  {name} (B={B}): {result[name]['device_ms']:.4f} device ms per launch, "
              f"{host_ms:.4f} host ms per call")
    print(json.dumps({"card": card, "root": root, "batch": B, "kernels": result}))


if __name__ == "__main__":
    main()
