"""Day-schedule generation (port of ``generate.py:46-147``).

:func:`generate_schedule` consumes a ``(B, T, 5, N)`` block of uniforms, the
per-env ``(T, 5, N)`` contract of the JAX ``generate_schedule(uniforms=...)``
(draw kinds: arrival, SoC, capacity, requested-SoC, departure), and returns
the same tables bit for bit: its two multiply-adds go through
``torch.addcmul``, which rounds once like the fused multiply-add XLA's CPU
backend emits for them.  The seeded path draws that block from a
``torch.Generator`` (:func:`draw_uniforms`).  The JSON replay helpers of the
JAX module are not ported yet.
"""

from __future__ import annotations

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
    """
    N, T, L = config.num_chargers, config.steps_per_day, config.table_len
    dtype, device = params.dtype, params.device
    if uniforms is None:
        if generator is None or batch is None:
            raise ValueError("generate_schedule needs uniforms, or a generator and a batch size")
        uniforms = draw_uniforms(config, batch, generator, dtype, device)
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
