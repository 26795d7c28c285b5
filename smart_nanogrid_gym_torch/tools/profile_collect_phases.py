"""Time the parts of a step of K2 and K9 seeded (the collection kernels) on the card.

Run from the root of the repository (it builds instrumented copies first):

    python3 -m smart_nanogrid_gym_torch.tools.profile_collect_phases

This tool writes a copy of ``csrc/day_step.cuh``, ``csrc/operand.cuh`` and
``csrc/kernels.cu`` into ``build/collect_phases/`` in which block 0 records
``%globaltimer`` at the borders of each step's parts (``instrument``): on
the env warp's lane 0 the step's start and its observation staged; on
product thread 0 the products' work in the env's window done (K2: vf's torso
and value; both: the next step's draws), each hidden layer done, the head
done, and (K9) the time spent waiting for the weight ring's chunks to land.
Every stamp is read before a barrier (one read right after a barrier may be
read before the barrier completes), so the env's window (physics of step t,
observation of step t + 1) runs from the head's stamp to the env's, and
layer 1 from the later of the two warps' arrivals. It builds the copy with
the package's nvcc flags for the 8-charger bench config (the PPO 64x64
actor-critic and the DDPG 400-300 actor), runs ``ppo_collect_day_seeded``
and ``ddpg_collect_day_seeded`` on it at the bench batch with seeded random
networks, and prints, for each kernel, the microseconds per step of each
part (mean over the steps of launches 3-6), the call's time by CUDA events
(the wrapper's host work included), and whether the outputs are
bit-identical to the uninstrumented kernel's. The repository's own sources and libraries are not
touched. The last line is one JSON object with the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from unittest import mock

import numpy as np
import torch

from ..ops import _build

BATCH = 4096  # the bench batch
LAUNCHES = 6  # launches of each kernel; the first two warm up
SLOTS = 16  # timer slots a step
STEPS = 64  # steps recorded
OUT_DIR = _build.BUILD_DIR.parent / "collect_phases"
# slot ids: env warp lane 0 (0-1), product thread 0 (5-9)
ENV_START, ENV_STAGED = 0, 1
PROD_LAYER1, PROD_LAYER2, PROD_HEAD, PROD_RING_WAIT, PROD_WINDOW = 5, 6, 7, 8, 9


def _sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"csrc/day_step.cuh has changed: {old!r} is not found {count} times")
    return text.replace(old, new)


def _clock(slot: int, thread: int) -> str:
    return (f"if (blockIdx.x == 0 && threadIdx.x == {thread} && t < {STEPS}) "
            f"ngc_clock[t * {SLOTS} + {slot}] = ngc_now();")


def instrument(cuh: str, cu: str) -> tuple[str, str]:
    """The day-kernel sources with block 0's step record and ``ngk_collect_clock``."""
    env, prod = 0, 32  # lane 0 of the env warp, product thread 0
    cuh = _sub(cuh, "constexpr int kCollectEnvs = 32;",
               f"__device__ unsigned long long ngc_clock[{STEPS * SLOTS}];\n"
               "__device__ unsigned long long ngc_ring_wait;\n"
               "__device__ __forceinline__ unsigned long long ngc_now() {\n"
               "  unsigned long long t;\n"
               "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t) :: \"memory\");\n"
               "  return t;\n}\n\nconstexpr int kCollectEnvs = 32;")
    # the env warps of both kernels
    cuh = _sub(cuh, "    float obs[C::F], pen[C::N];\n    StepState<C> st;\n",
               f"    {_clock(ENV_START, env)}\n    float obs[C::F], pen[C::N];\n    StepState<C> st;\n", count=2)
    cuh = _sub(cuh, "    sync_block();  // the observations are staged\n",
               f"    {_clock(ENV_STAGED, env)}\n    sync_block();  // the observations are staged\n", count=2)
    # the product warps of both kernels: the window's work (K2: vf's torso and value of step t - 1;
    # both: the draws of step t + 1) done, the policy's products done
    for call in ("ppo_policy_products<C>(s, p, t, act_out, B, l.b0);",
                 "ddpg_products<C>(s, ring, g, p, t, ou, act_out, B, l.b0);"):
        cuh = _sub(cuh, f"      sync_block();\n      {call}\n      sync_block();\n",
                   f"      {_clock(PROD_WINDOW, prod)}\n"
                   f"      sync_block();\n      {call}\n"
                   f"      {_clock(PROD_HEAD, prod)}\n"
                   f"      if (blockIdx.x == 0 && threadIdx.x == {prod} && t < {STEPS}) "
                   f"ngc_clock[t * {SLOTS} + {PROD_RING_WAIT}] = ngc_ring_wait;\n"
                   "      sync_block();\n")
    for bias, slot in (("b1", PROD_LAYER1), ("b2", PROD_LAYER2)):
        h = "h1" if bias == "b1" else "h2"
        P = "P1" if bias == "b1" else "P2"
        old = (f"    tile.template store<kPpoActor>(s.{bias}, j0, 2 * S::{P}, s.{h} + e0);\n  }}\n"
               "  sync_products<kPpoProductThreads>();\n")
        cuh = _sub(cuh, old, old + f"  if (side == 0) {{ {_clock(slot, prod)} }}\n")
    cuh = _sub(cuh, "(ring, g, p, s.xs, s.b1, s.h1);\n",
               f"(ring, g, p, s.xs, s.b1, s.h1);\n  {_clock(PROD_LAYER1, prod)}\n")
    cuh = _sub(cuh, "(ring, g, p, s.h1, s.b2, s.h2);\n",
               f"(ring, g, p, s.h1, s.b2, s.h2);\n  {_clock(PROD_LAYER2, prod)}\n")
    cuh = _sub(cuh, "    mbarrier_wait(full + g % G::STAGES, G::RESIDENT ? 0 : (g / G::STAGES) & 1);\n",
               "    const unsigned long long waited = ngc_now();\n"
               "    mbarrier_wait(full + g % G::STAGES, G::RESIDENT ? 0 : (g / G::STAGES) & 1);\n"
               f"    if (blockIdx.x == 0 && threadIdx.x == {prod}) ngc_ring_wait += ngc_now() - waited;\n")
    cu = cu + ('\nextern "C" int ngk_collect_clock(unsigned long long* out) {\n'
               "  const unsigned long long zero = 0;\n"
               "  cudaError_t err = cudaMemcpyFromSymbol(out, ngk::ngc_clock, sizeof(ngk::ngc_clock));\n"
               "  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ngk::ngc_ring_wait, &zero, sizeof(zero));\n"
               "  return static_cast<int>(err);\n}\n")
    return cuh, cu


def build_instrumented(spec: _build.Spec) -> ctypes.CDLL:
    cuh, cu = instrument((_build.CSRC / "day_step.cuh").read_text(), (_build.CSRC / "kernels.cu").read_text())
    lib = _build.patched_library(spec, OUT_DIR, {"day_step.cuh": lambda _: cuh, "kernels.cu": lambda _: cu})
    lib.ngk_collect_clock.argtypes = [ctypes.c_void_p]
    lib.ngk_collect_clock.restype = ctypes.c_int
    return lib


def step_parts(record: np.ndarray, T: int, ddpg: bool) -> dict[str, np.ndarray]:
    """Nanoseconds of each part of each of the first T - 1 steps."""
    r = record.reshape(STEPS, SLOTS)[:T].astype(np.int64)
    nxt = r[1:, ENV_START]
    r = r[:-1]
    wait = np.diff(np.concatenate([[0], r[:, PROD_RING_WAIT]])) if ddpg else None
    # the stamps taken before a barrier are ordered; one taken right after a
    # barrier may be read before it, so the window and layer 1 start at the
    # later of the two warps' arrivals
    env = r[1:, ENV_STAGED] - r[:-1, PROD_HEAD]    # physics of step t, observation of t + 1
    work = r[1:, PROD_WINDOW] - r[:-1, PROD_HEAD]  # the products' work meanwhile
    start = np.maximum(r[:, ENV_STAGED], r[:, PROD_WINDOW])
    last = lambda x: np.concatenate([x, x[-1:]])  # noqa: E731
    parts = {
        "step": nxt - r[:, ENV_START],
        "env: observation (generation, staging)": r[:, ENV_STAGED] - r[:, ENV_START],
        "env: physics of step t and observation of t + 1": last(env),
        "products meanwhile (K2: vf's torso and value; the draws)": last(work),
        "products: layer 1": r[:, PROD_LAYER1] - start,
        "products: layer 2": r[:, PROD_LAYER2] - r[:, PROD_LAYER1],
        "products: head": r[:, PROD_HEAD] - r[:, PROD_LAYER2],
    }
    if ddpg:
        parts["products: waiting for weight chunks (in the layers)"] = wait[:len(r)]
    return parts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_collect_phases needs a CUDA device")
    from ..core import NanogridConfig, make_params
    from ..ops.collect import ppo_collect_day_seeded
    from ..ops.ddpg_collect import ddpg_collect_day_seeded
    from ..solvers.networks import ActorCritic, DDPGActor, actor_critic_leaves, ddpg_leaves

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg, B = NanogridConfig(), BATCH
    T, A = cfg.steps_per_day, cfg.num_actions
    dev = torch.device("cuda")
    params = make_params(cfg, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    batt = torch.rand(B, generator=gen, device=dev)
    ou = 0.3 * torch.randn((T, A, B), generator=gen, device=dev)
    ppo = [x.detach().to(dev) for x in actor_critic_leaves(
        ActorCritic(cfg.obs_dim, A, generator=torch.Generator().manual_seed(1)))]
    low, high = cfg.action_bounds()
    ddpg = [x.detach().to(dev) for x in ddpg_leaves(
        DDPGActor(cfg.obs_dim, A, low, high, generator=torch.Generator().manual_seed(2)))]
    kernels = {
        "K2 ppo_collect_day_seeded": (_build.config_spec(cfg), False,
                                      lambda: ppo_collect_day_seeded(cfg, params, ppo, 11, batt, B)),
        "K9 ddpg_collect_day_seeded": (_build.config_spec(cfg, (400, 300), "ddpg"), True,
                                       lambda: ddpg_collect_day_seeded(cfg, params, ddpg, 11, ou, batt, B)),
    }
    print(f"card: {card}")
    result = {"card": card, "batch": B}
    for label, (spec, is_ddpg, call) in kernels.items():
        plain_out = call()  # the package's own kernel
        lib = build_instrumented(spec)
        record = np.zeros(STEPS * SLOTS, np.uint64)
        samples, events = [], []
        with mock.patch.object(_build, "load", return_value=lib):
            for rep in range(LAUNCHES):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = call()
                end.record()
                torch.cuda.synchronize()
                if lib.ngk_collect_clock(record.ctypes.data) != 0:
                    raise RuntimeError("reading the step record failed")
                if rep >= 2:
                    samples.append(step_parts(record, T, is_ddpg))
                    events.append(start.elapsed_time(end))
        same = all(torch.equal(a, b) for a, b in zip(out, plain_out))
        parts = {k: float(np.mean([s[k] for s in samples])) / 1e3 for k in samples[0]}
        print(f"{label} at B={B}: {float(np.mean(events)):.4f} ms per call by CUDA events (wrapper included); outputs "
              f"{'bit-identical to' if same else 'DIFFER from'} the uninstrumented kernel's")
        for k, us in parts.items():
            print(f"  {k}: {us:.3f} us per step")
        result[label] = {"launch_ms_events": float(np.mean(events)), "identical": same, "step_us": parts}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
