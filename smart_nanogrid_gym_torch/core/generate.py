"""Day-schedule generation (port of ``generate.py:46-147``).

:func:`generate_schedule` consumes a ``(B, T, 5, N)`` block of uniforms, the
per-env ``(T, 5, N)`` contract of the JAX ``generate_schedule(uniforms=...)``
(draw kinds: arrival, SoC, capacity, requested-SoC, departure), and returns
the same tables bit for bit: its two multiply-adds go through
``torch.addcmul``, which rounds once like the fused multiply-add XLA's CPU
backend emits for them.  The seeded path draws that block from a
``torch.Generator`` (:func:`draw_uniforms`).  On the CPU the eager loop
:func:`generate_schedule_plain` builds the tables; on the card one launch of
the kernel of ``csrc/generate.cu`` does, bit-equal to that loop.  That
dispatch, like ``transition.step``'s, imports from ``ops`` at the call,
since ``ops`` imports ``core``.

The host-side replay helpers (``generate.py:149-289``) read and write the
reference's ``initial_values.json`` day: :func:`schedule_from_arrays`,
:func:`load_initial_values_json` and :func:`schedule_to_json_dict` work on
one env's ``(N, L)`` tables, as the JAX helpers do.
:func:`schedule_from_reference_seed` replays the day the reference generates
under ``np.random.seed(seed)`` bit for bit (the native MT19937 generator of
:mod:`..native`), and :func:`schedules_from_reference_seeds` stacks one such
day per seed into ``(B, N, L)`` tables for the batched engine and the kernels.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .config import NanogridConfig

from .params import NanogridParams, broadcast_params
from .state import DaySchedule


def draw_uniforms(
    config: NanogridConfig,
    batch: int,
    generator: torch.Generator,
    dtype: torch.dtype,
    device: torch.device | str,
) -> torch.Tensor:
    """A fresh ``(B, T, 5, N)`` uniform block from ``generator``."""
    shape = (batch, config.steps_per_day, 5, config.num_chargers)
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def draw_pv_percent(batch: int, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """randint(0, 180) with both ends inclusive (env.py:349): the PV shift in
    percent, int64."""
    return torch.randint(0, 181, (batch,), generator=generator, device=device)


def _uniform_block(config: NanogridConfig, params: NanogridParams, uniforms: torch.Tensor | None,
                   generator: torch.Generator | None, batch: int | None) -> torch.Tensor:
    """``uniforms``, or a block drawn from ``generator``."""
    if uniforms is not None:
        return uniforms
    if generator is None or batch is None:
        raise ValueError("generate_schedule needs uniforms, or a generator and a batch size")
    return draw_uniforms(config, batch, generator, params.dtype, params.device)


def generate_schedule(
    config: NanogridConfig,
    params: NanogridParams,
    uniforms: torch.Tensor | None = None,
    *,
    generator: torch.Generator | None = None,
    batch: int | None = None,
) -> DaySchedule:
    """One day's schedule per env, ``(B, N, L)`` tables.

    Pass ``uniforms (B, T, 5, N)``, or ``generator`` and ``batch`` to draw them.
    With params on the CPU the plain twin :func:`generate_schedule_plain`
    builds the tables; on a CUDA device the kernel of ``csrc/generate.cu``
    writes them in one launch (``ops/generate.py::generate_day``, f32 or
    f64), bit for bit the same; another device raises ``ValueError``.  Each
    checks the block's shape.
    """
    uniforms = _uniform_block(config, params, uniforms, generator, batch)
    # from core into ops at the call, once: ops imports core
    from ..ops import _build, generate as kernel

    if not _build.kernel_device(params.price):
        return generate_schedule_plain(config, params, uniforms)
    return kernel.generate_day(config, params, uniforms)


def generate_schedule_plain(
    config: NanogridConfig,
    params: NanogridParams,
    uniforms: torch.Tensor | None = None,
    *,
    generator: torch.Generator | None = None,
    batch: int | None = None,
) -> DaySchedule:
    """:func:`generate_schedule` as an eager loop of element-wise ops, on
    any device: the kernel's twin."""
    N, T, L = config.num_chargers, config.steps_per_day, config.table_len
    dtype, device = params.dtype, params.device
    uniforms = _uniform_block(config, params, uniforms, generator, batch)
    B = uniforms.shape[0]
    if tuple(uniforms.shape) != (B, T, 5, N):
        raise ValueError(f"uniforms must be (B, {T}, 5, {N}), got {tuple(uniforms.shape)}")
    u = uniforms.to(dtype)
    p = broadcast_params(params, B)

    def col(x):  # per-env scalar param against (B, N)
        return x[:, None]

    k4 = int(4 / config.time_interval)
    k10 = int(10 / config.time_interval)
    k1 = int(1 / config.time_interval)

    present = torch.zeros((B, N), dtype=torch.bool, device=device)
    dep = torch.zeros((B, N), dtype=torch.int64, device=device)
    cap = torch.zeros((B, N), dtype=dtype, device=device)
    req = torch.zeros((B, N), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)

    outs = {k: [] for k in ("occ", "cap", "req", "soc0", "arr", "dep", "m1", "m3")}
    for t in range(T):
        u_arr, u_soc, u_cap, u_req, u_dep = u[:, t].unbind(1)

        arrives = ~present & (u_arr > col(p.arrival_threshold))
        soc_t = torch.addcmul(col(p.soc_low), col(p.soc_span), u_soc)
        if config.different_battery_capacities:
            cap_new = col(p.cap_low) + torch.floor(u_cap * col(p.cap_span))
        else:
            cap_new = col(p.default_capacity).expand(B, N)
        if config.requested_state_of_charge:
            soc_prime = torch.clamp(soc_t + 0.1, max=1.0)
            req_new = torch.addcmul(soc_prime, 1.0 - soc_prime, u_req)
        else:
            req_new = torch.ones((B, N), dtype=dtype, device=device)

        low = t + k4
        high = min(t + k10, T + k1)
        if low >= high:  # no-draw branch (charging_station.py:271-279)
            dep_new = torch.full((B, N), low, dtype=torch.int64, device=device)
        else:
            dep_new = low + torch.floor(u_dep * float(max(high - low, 1))).to(torch.int64)

        present = present | arrives
        dep = torch.where(arrives, dep_new, dep)
        cap = torch.where(arrives, cap_new, cap)
        req = torch.where(arrives, req_new, req)
        occupied = present & (t < dep)

        outs["occ"].append(occupied.to(dtype))
        outs["cap"].append(torch.where(occupied, cap, zero))
        outs["req"].append(torch.where(occupied, req, zero))
        outs["soc0"].append(torch.where(arrives, soc_t, zero))
        outs["arr"].append(arrives.to(dtype))
        outs["dep"].append(torch.where(occupied, (dep - t).to(dtype), zero))
        outs["m1"].append((occupied & (dep == t + 1)).to(dtype))
        outs["m3"].append((occupied & (dep <= t + 3)).to(dtype))
        # a charger whose vehicle departed is free at the next step
        present = occupied

    mask = p.charger_mask[:, :, None]

    def table(cols):  # T x (B, N) -> (B, N, L), trailing zero columns
        x = torch.stack(cols, dim=-1)
        return torch.nn.functional.pad(x, (0, L - T)) * mask

    return DaySchedule(
        occupancy=table(outs["occ"]),
        capacity=table(outs["cap"]),
        requested_soc=table(outs["req"]),
        soc_init=table(outs["soc0"]),
        is_arrival=table(outs["arr"]),
        dep_obs=table(outs["dep"]),
        mask_departing=table(outs["m1"]),
        mask_departing3=table(outs["m3"]),
    )


# ---------------------------------------------------------------------------
# Host-side exact replay from recorded schedules
# ---------------------------------------------------------------------------


def schedule_from_arrays(
    config: NanogridConfig,
    soc,
    arrivals: list[list[int]],
    departures: list[list[int]],
    occupancy,
    capacities,
    requested_soc=None,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
) -> DaySchedule:
    """One env's schedule, ``(N, L)`` tables, from reference-format day arrays
    (charging_station.py:119-136,164-180), built on the host with numpy.

    The lookup tables reproduce the reference's per-step list searches:

    - ``dep_obs[c, t]`` = first departure >= t, minus t, while occupied
      (charging_station.py:92-112);
    - ``mask_departing[c, t]`` = occupied and t+1 in departures[c] (:79-84);
    - ``mask_departing3[c, t]`` = occupied and {t+1, t+2, t+3} meets
      departures[c] (:86-90; the reference ignores its ``n``, SURVEY.md Q10);
    - ``is_arrival[c, t]`` = t in arrivals[c] (the charger-level list).

    Without ``requested_soc`` every occupied step requests 1.
    """
    N, T, L = config.num_chargers, config.steps_per_day, config.table_len

    def fit(arr):
        arr = np.asarray(arr, dtype=np.float64)
        out = np.zeros((N, L), dtype=np.float64)
        cols = min(L, arr.shape[1])
        out[:, :cols] = arr[:, :cols]
        return out

    occ = fit(occupancy)
    req = np.where(occ > 0, 1.0, 0.0) if requested_soc is None else fit(requested_soc)
    is_arr = np.zeros((N, L))
    dep_obs = np.zeros((N, L))
    m1 = np.zeros((N, L))
    m3 = np.zeros((N, L))
    for c in range(N):
        arr_set = {int(a) for a in arrivals[c]}
        deps = [int(d) for d in departures[c]]
        dep_set = set(deps)
        for t in range(T):
            if t in arr_set:
                is_arr[c, t] = 1.0
            if occ[c, t] > 0:
                for d in deps:
                    if t <= d:
                        dep_obs[c, t] = d - t
                        break
                if (t + 1) in dep_set:
                    m1[c, t] = 1.0
                if (t + 1) in dep_set or (t + 2) in dep_set or (t + 3) in dep_set:
                    m3[c, t] = 1.0

    def table(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return DaySchedule(
        occupancy=table(occ),
        capacity=table(fit(capacities)),
        requested_soc=table(req),
        soc_init=table(fit(soc)),
        is_arrival=table(is_arr),
        dep_obs=table(dep_obs),
        mask_departing=table(m1),
        mask_departing3=table(m3),
    )


def _native_tables(seed: int, config: NanogridConfig) -> dict:
    from ..native import generate_schedule_native

    return generate_schedule_native(
        seed, config.num_chargers, config.time_interval, table_len=config.table_len,
        different_capacities=config.different_battery_capacities,
        requested_soc=config.requested_state_of_charge)


def schedule_from_reference_seed(seed: int, config: NanogridConfig, dtype: torch.dtype = torch.float64,
                                 device: torch.device | str = "cuda") -> DaySchedule:
    """One env's ``(N, L)`` schedule **bit-identical** to what the reference
    generates under ``np.random.seed(seed)`` (charging_station.py:152-186),
    from the native C++ MT19937 generator (:mod:`..native`, a host engine),
    moved to ``device``.  With :func:`..core.transition.reset` this replays a
    trajectory from the bare seed, the correctness north star."""
    tables = _native_tables(seed, config)
    return DaySchedule(*(torch.as_tensor(tables[name], device=device).to(dtype) for name in DaySchedule._fields))


def schedules_from_reference_seeds(seeds, config: NanogridConfig, dtype: torch.dtype = torch.float64,
                                   device: torch.device | str = "cuda") -> DaySchedule:
    """:func:`schedule_from_reference_seed` for each of ``seeds``, stacked into
    ``(B, N, L)`` tables on ``device``: one native call per seed on the host,
    one copy to the device per table."""
    days = [_native_tables(int(s), config) for s in seeds]
    return DaySchedule(*(torch.as_tensor(np.stack([d[name] for d in days]), device=device).to(dtype)
                         for name in DaySchedule._fields))


def load_initial_values_json(path: str, config: NanogridConfig, dtype: torch.dtype = torch.float64,
                             device: torch.device | str = "cuda") -> DaySchedule:
    """One env's schedule from a reference-format ``initial_values.json``
    (keys per charging_station.py:173-180; ``Requested_SOC`` optional)."""
    with open(path) as fp:
        initials = json.load(fp)
    return schedule_from_arrays(
        config,
        soc=initials["SOC"],
        arrivals=initials["Arrivals"],
        departures=initials["Departures"],
        occupancy=initials["Charger_occupancy"],
        capacities=initials["Vehicle_capacities"],
        requested_soc=initials.get("Requested_SOC"),
        dtype=dtype,
        device=device,
    )


def schedule_to_json_dict(schedule: DaySchedule, config: NanogridConfig) -> dict:
    """One env's ``(N, L)`` schedule in the reference's ``initial_values.json``
    layout (charging_station.py:173-180)."""
    T = config.steps_per_day
    host = DaySchedule(*(x.detach().cpu().numpy() for x in schedule))
    arrivals, departures = [], []
    for c in range(config.num_chargers):
        arr_ts = [t for t in range(T) if host.is_arrival[c, t] > 0]
        arrivals.append(arr_ts)
        departures.append([int(t + host.dep_obs[c, t]) for t in arr_ts])
    return {
        "SOC": host.soc_init.tolist(),
        "Arrivals": arrivals,
        "Departures": departures,
        "Charger_occupancy": host.occupancy.tolist(),
        "Vehicle_capacities": host.capacity.tolist(),
        "Requested_SOC": host.requested_soc.tolist(),
    }
