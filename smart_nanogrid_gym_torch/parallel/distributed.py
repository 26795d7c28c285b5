"""Multi-process runtime (port of ``parallel/distributed.py``).

The reference is strictly single-process (SURVEY.md §2.3).  The JAX package
spans hosts with ``jax.distributed`` and one global device mesh; the port
runs one process per card on ``torch.distributed`` (``torchrun
--nproc-per-node``):

- **process wiring**: :func:`initialize_distributed` opens the default
  process group from its arguments or torch's launcher variables
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``); it is a no-op in one process, so every entry point can
  call it unconditionally;
- **one env mesh**: :func:`global_env_mesh`, each rank a contiguous slice of
  the global env batch (:func:`host_shard_bounds`); the rollout needs no
  collective (the learner's gradient mean is the only cross-rank traffic);
- **rank-local day generation**: each rank draws only its own envs' days,
  from Philox keyed by ``(seed, global env index)`` (:func:`global_env_keys`),
  so the days are bit-identical under any number of processes;
- **global tensors where needed**: :func:`make_global_array` gathers the
  shards on every rank.

:func:`sharded_multiday_kernel_fn` runs K8 or K6 once per rank on its own
envs, and :func:`scaling_sweep` times the world the process runs in.
"""

from __future__ import annotations

import datetime
import json
import os
import time

import torch
import torch.distributed as dist

from ..core.config import NanogridConfig
from ..core.generate import generate_schedule
from ..core.params import NanogridParams, broadcast_params
from ..core.transition import reset
from ..ops.philox import day_uniforms
from .mesh import EnvMesh, _map, make_mesh, replicate, sharded_rollout_fn

KERNELS = ("rbc", "policy")
MAX_SEED = 0xFFFFFFFF  # the kernels key Philox with a 32-bit seed


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> tuple[int, int]:
    """Open the default process group for a multi-process run; a no-op in one
    process and when a group already exists.

    ``coordinator_address``: ``host:port`` (TCP), or an init method such as
    ``file:///path``; it falls back to ``MASTER_ADDR``/``MASTER_PORT``,
    ``num_processes`` to ``WORLD_SIZE`` and ``process_id`` to ``RANK``.
    ``backend`` defaults to ``nccl`` where a card is present, else ``gloo``;
    with NCCL this rank's card is ``cuda:LOCAL_RANK``.  A rendezvous that does
    not complete within ``timeout_s`` raises.  Returns ``(rank, world_size)``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and this process's id "
                         "(arguments, or WORLD_SIZE and RANK)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=_init_method(coordinator_address), world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def global_env_mesh(device: torch.device | str | None = None, group=None) -> EnvMesh:
    """The env mesh over every rank of the (default) process group."""
    return make_mesh(device, group)


def host_shard_bounds(mesh: EnvMesh, global_batch: int) -> tuple[int, int]:
    """This rank's contiguous ``[rank·B/W, (rank+1)·B/W)`` of the global env
    axis; raises ``ValueError`` unless the world size divides the batch."""
    return mesh.shard_bounds(global_batch)


def make_global_array(tree, mesh: EnvMesh, global_batch: int | None = None):
    """Every rank's shard (leading axis the local batch) gathered into the
    global batch on every rank, for a caller that needs the global tensor."""
    def leaf(x):
        if global_batch is not None and x.shape[0] * mesh.world_size != global_batch:
            raise ValueError(f"a shard of {x.shape[0]} envs on {mesh.world_size} ranks is not {global_batch}")
        return mesh.all_gather(x)

    return _map(leaf, tree)


def replicate_global(tree, mesh: EnvMesh):
    """Rank 0's values on every rank (:func:`.mesh.replicate`); every rank
    passes the same values when they come from a shared seed."""
    return replicate(tree, mesh)


def global_env_keys(seed: int, lo: int, hi: int, config: NanogridConfig,
                    device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor]:
    """The day-0 draws of global envs ``[lo, hi)``: ``(uniforms (hi-lo, T, 5,
    N), u_pv (hi-lo,))`` as f32, from the port's Philox keyed by ``(seed,
    global env index)`` (``ops/philox.py::day_uniforms``), so that a slice
    of a global batch draws what the whole batch draws there (the JAX
    package's ``fold_in(seed, global_index)``)."""
    u, u_pv = day_uniforms(seed, 0, hi - lo, config.steps_per_day, config.num_chargers, device, env0=lo)
    return u.permute(3, 0, 1, 2).contiguous(), u_pv


def distributed_reset(config: NanogridConfig, params: NanogridParams, mesh: EnvMesh, global_batch: int,
                      seed: int = 0):
    """Rank-local day generation: this rank's ``[lo, hi)`` envs generated from
    :func:`global_env_keys` (the PV shift from the same key), then reset.
    Returns ``(bparams, states, obs)`` of this rank's envs, ``bparams`` the
    params broadcast to them; :func:`make_global_array` gathers the global
    batch."""
    from ..ops.gen_rollout import pv_shift_from_uniform

    lo, hi = host_shard_bounds(mesh, global_batch)
    u, u_pv = global_env_keys(seed, lo, hi, config, params.device)
    schedule = generate_schedule(config, params, u.to(params.dtype))
    states, obs = reset(config, params, schedule, pv_shift=pv_shift_from_uniform(u_pv).to(params.dtype))
    return broadcast_params(params, hi - lo), states, obs


# ---------------------------------------------------------------------------
# the multiday kernels, one launch per rank
# ---------------------------------------------------------------------------


def rank_seed(seed: int, mesh: EnvMesh) -> int:
    """The seed rank ``r`` of ``W`` launches with: ``seed·W + r``, disjoint
    across ranks and seeds, the bare ``seed`` at world size 1.  Raises when
    it does not fit in the kernels' 32-bit key (a wrapped seed would reuse
    another call's streams)."""
    dev_seed = int(seed) * mesh.world_size + mesh.rank
    if not 0 <= dev_seed <= MAX_SEED:
        raise ValueError(f"seed {seed} on {mesh.world_size} ranks gives the kernel seed {dev_seed}, "
                         f"outside [0, 2**32); the kernels key Philox with 32 bits")
    return dev_seed


def sharded_multiday_kernel_fn(
    config: NanogridConfig,
    mesh: EnvMesh,
    num_days: int,
    batch_per_device: int,
    kernel: str = "rbc",
    net_params=None,
    gather: bool = False,
    **kernel_kwargs,
):
    """The multiday kernels over the env mesh: each rank launches K8
    (``kernel="rbc"``, ``ops/gen_rollout.py::gen_rbc_multiday``) or K6
    (``"policy"``, ``ops/gen_policy_rollout.py::gen_policy_multiday`` with
    the module ``net_params`` and optional ``mlp_dtype``/``actor``) on its own
    ``batch_per_device`` envs, with **no collective**.

    The wrappers check ``params`` against the constants the kernels bake
    (``ops/param_guard.py``) before their launch, once a call.

    Per-rank streams are disjoint: rank ``r`` of ``W`` runs with the seed
    ``seed·W + r`` (:func:`rank_seed`; the port's Philox is keyed by ``(seed,
    env)``), so at world size 1 a run is bit-identical to the unsharded call.
    Returns ``run(params, seed) -> stats``: this rank's ``(rows,
    batch_per_device)`` (K8: Σ, Σ² of the day returns; K6 also the final
    battery), or with ``gather=True`` every rank's, ``(rows, W ·
    batch_per_device)`` in rank order.  On CPU params the kernels' twins run.
    """
    if kernel == "rbc":
        from ..ops.gen_rollout import gen_rbc_multiday

        def launch(params, dev_seed):
            return gen_rbc_multiday(config, params, num_days, dev_seed, batch_per_device)
    elif kernel == "policy":
        from ..ops.gen_policy_rollout import gen_policy_multiday

        if net_params is None:
            raise ValueError("kernel='policy' needs net_params (the actor module)")

        def launch(params, dev_seed):
            return gen_policy_multiday(config, params, net_params, num_days, dev_seed, batch_per_device,
                                       **kernel_kwargs)
    else:
        raise ValueError(f"unknown kernel {kernel!r}, expected one of {KERNELS}")

    def run(params: NanogridParams, seed: int) -> torch.Tensor:
        stats = launch(params, rank_seed(seed, mesh))
        return mesh.all_gather(stats, dim=1) if gather else stats

    return run


# ---------------------------------------------------------------------------
# scaling measurement
# ---------------------------------------------------------------------------


def _timed_seconds(fn, calls: int, device: torch.device) -> float:
    """Seconds of ``calls`` calls of ``fn(i)`` after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i + 1)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i + 1)
    return time.perf_counter() - t0


def scaling_sweep(
    config: NanogridConfig,
    params: NanogridParams,
    mesh: EnvMesh,
    batch_per_device: int = 512,
    num_days: int = 20,
    timed_calls: int = 3,
    path: str = "auto",
) -> list[dict]:
    """Closed-loop throughput of the world this process runs in, at a fixed
    batch per rank (weak scaling), against linear extrapolation of one rank.

    torch has no list of devices inside one process, so the sweep measures
    one rank alone (rank 0, the others waiting) and then, at world size > 1,
    every rank at once.  ``path``: ``"kernel"`` runs K8 on each rank
    (:func:`sharded_multiday_kernel_fn`, CUDA events), ``"plain"`` the plain
    engine's rollout (:func:`.mesh.sharded_rollout_fn` with the RBC, the
    host clock), ``"auto"`` the kernel on the card and the plain engine on
    the CPU.  Each rank's time is reduced to the slowest rank's.  Returns
    one record per world size: ``{"devices", "global_batch",
    "steps_per_sec", "efficiency", "path"}``, equal on every rank.
    """
    if path == "auto":
        path = "kernel" if mesh.device.type == "cuda" else "plain"
    if path not in ("kernel", "plain"):
        raise ValueError(f"unknown path {path!r}, expected 'kernel', 'plain' or 'auto'")
    sizes = [1, mesh.world_size] if mesh.world_size > 1 else [1]
    results, base_rate = [], None
    for n in sizes:
        sub = mesh if n == mesh.world_size else EnvMesh(None, 0, 1, mesh.device)
        seconds = 0.0
        mesh.barrier()
        if mesh.rank < n:
            global_batch = batch_per_device * n
            if path == "kernel":
                run = sharded_multiday_kernel_fn(config, sub, num_days, batch_per_device, kernel="rbc")

                def call(i):
                    return run(params, i)
            else:
                from ..core.transition import draw_pv_shift
                from ..solvers.rbc import make_rbc_policy_fn

                _, states, obs = distributed_reset(config, params, sub, global_batch)
                rollout = sharded_rollout_fn(config, sub, make_rbc_policy_fn(config),
                                             num_steps=num_days * config.steps_per_day)
                gen = torch.Generator().manual_seed(1)
                shifts = torch.stack([draw_pv_shift(global_batch, gen, params.dtype, "cpu")
                                      for _ in range(num_days)])

                def call(i):
                    return rollout(params, states, obs, shifts)
            seconds = _timed_seconds(call, timed_calls, mesh.device)
        seconds = float(mesh.all_reduce_max(torch.tensor([seconds], dtype=torch.float64)))
        rate = batch_per_device * n * config.steps_per_day * num_days * timed_calls / seconds
        base_rate = base_rate or rate
        results.append({"devices": n, "global_batch": batch_per_device * n, "steps_per_sec": rate,
                        "efficiency": rate / (base_rate * n), "path": path})
    return results


def write_scaling_report(results: list[dict], path: str, meta: dict | None = None) -> None:
    """``{"records": results, **meta}`` as JSON at ``path`` (the caller's path only)."""
    payload = {"records": results}
    if meta:
        payload.update(meta)
    with open(path, "w") as fp:
        json.dump(payload, fp, indent=2)
