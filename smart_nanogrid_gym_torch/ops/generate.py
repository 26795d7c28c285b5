"""Day generation in one launch: the kernel of ``csrc/generate.cu``.

:func:`generate_day` writes the eight ``(B, N, L)`` tables of
``core/generate.py::generate_schedule`` from a ``(B, T, 5, N)`` uniform
block on the card, bit-equal to the plain twin
``core/generate.py::generate_schedule_plain`` in f32 and f64.  It replaces
no Pallas kernel: XLA fuses the JAX package's step loop, which the eager twin
runs as about 800 launches a day at 1 h.  ``generate_schedule`` calls it for
params on a CUDA device and the twin for params on the CPU.

A thread carries one (env, charger) pair through the day, reading its
uniforms and writing its rows of the tables in global memory.  The params
are read through their strides (an unbatched param with stride 0), so
nothing is copied or viewed before the launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.state import DaySchedule
from . import _build

LAUNCH_NAME = "generate_day"
DTYPES = (torch.float32, torch.float64)
# the kernel's params in the order of its arguments (csrc/generate.cu GenParam)
GEN_PARAMS = ("arrival_threshold", "soc_low", "soc_span", "cap_low", "cap_span", "default_capacity")


def _env_stride(x: torch.Tensor, name: str, batch: int) -> int:
    """A per-env param's element stride along the env axis: 0 for one value
    shared by every env (no view is made: under a profiler each op costs
    tens of microseconds of host time)."""
    if x.dim() == 0:
        return 0
    if tuple(x.shape) != (batch,):
        raise ValueError(f"params.{name} must be a scalar or ({batch},), got {tuple(x.shape)}")
    return x.stride(0)


def generate_day(config: NanogridConfig, params: NanogridParams, uniforms: torch.Tensor) -> DaySchedule:
    """The day's eight ``(B, N, L)`` tables from ``uniforms (B, T, 5, N)``
    in one launch, in the params' dtype (f32 or f64) on their CUDA device;
    views of one ``(8, B, N, L)`` tensor."""
    N, T, L = config.num_chargers, config.steps_per_day, config.table_len
    dtype, device = params.dtype, params.device
    if uniforms.dim() != 4 or tuple(uniforms.shape[1:]) != (T, 5, N):
        raise ValueError(f"uniforms must be (B, {T}, 5, {N}), got {tuple(uniforms.shape)}")
    if device.type != "cuda":
        raise ValueError(f"generate_day needs params on a CUDA device, got {device}")
    if dtype not in DTYPES:
        raise ValueError(f"generate_day takes float32 or float64 params, got {dtype}")
    B = uniforms.shape[0]
    u = uniforms if uniforms.dtype == dtype else uniforms.to(dtype)
    if not u.is_contiguous():
        u = u.contiguous()
    values = [getattr(params, name) for name in GEN_PARAMS]
    strides = [_env_stride(x, name, B) for x, name in zip(values, GEN_PARAMS)]
    mask = params.charger_mask
    if tuple(mask.shape) == (N,):
        strides += [0, mask.stride(0)]
    elif tuple(mask.shape) == (B, N):
        strides += list(mask.stride())
    else:
        raise ValueError(f"params.charger_mask must be ({N},) or ({B}, {N}), got {tuple(mask.shape)}")
    for name, x in zip((*GEN_PARAMS, "charger_mask"), (*values, mask)):
        if x.dtype != dtype:
            raise ValueError(f"params.{name} is {x.dtype}, the params are {dtype}")
    out = torch.empty((8, B, N, L), dtype=dtype, device=device)
    _, k4, k10, k1, _ = _build.day_dims(config)
    lib = _build.load(_build.engine_spec(config), device)
    _build.launch(LAUNCH_NAME, lib.ngk_generate_day, u, *values, mask, out, (ctypes.c_longlong * 8)(*strides),
                  B, T, L, k4, k10, k1, int(dtype == torch.float64), device=device)
    return DaySchedule(*out.unbind(0))
