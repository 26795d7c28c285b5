"""Generalised advantage estimation in one launch: the kernel of ``csrc/gae.cu``.

:func:`gae` computes the advantages and returns of a ``(T, B)`` rollout,
bit-equal to the eager twin :func:`gae_plain` in f32 and f64.  It replaces
no Pallas kernel: the JAX package's ``PPOLearner._gae`` is a ``lax.scan``
that XLA compiles into one loop, which the twin runs as 9 launches a step.
CUDA tensors go to the kernel, CPU tensors to the twin.

A thread carries one env backwards through the day.  The inputs are read
through their strides, so nothing is copied before the launch; the outputs
are ``(T, B)`` contiguous, as the twin's are.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCH_NAME = "gae"
DTYPES = (torch.float32, torch.float64)


def gae_plain(rewards, values, dones, last_value, gamma: float, lam: float):
    """The eager twin: advantages and returns of the ``(T, B)`` rollout,
    bootstrapped from ``last_value (B,)`` and cut where ``dones``."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t].to(values.dtype)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        next_value = values[t]
        out.append(gae)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values


def _check(x: torch.Tensor, name: str, shape: tuple, dtype, device: torch.device) -> None:
    """Raises where the kernel does not take ``x``: a shape, dtype or device
    other than its, or a tensor that requires grad."""
    if x.shape != shape:
        raise ValueError(f"gae: {name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"gae: {name} is {x.dtype}, needs {dtype}")
    if x.device != device:
        raise ValueError(f"gae: {name} is on {x.device}, the values on {device}")
    if x.requires_grad:
        raise ValueError(f"gae takes no operand that requires grad: {name} does")


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """``(advantages, returns)``, each ``(T, B)``, of ``rewards`` and
    ``values (T, B)``, ``dones (T, B)`` and ``last_value (B,)``: on a CUDA
    device one launch, bit for bit :func:`gae_plain`'s; on the CPU the twin.
    The kernel takes f32 or f64 rewards, values and last value of one dtype
    and bool dones, and raises before it launches on anything else."""
    if not _build.kernel_device(values):
        return gae_plain(rewards, values, dones, last_value, gamma, lam)
    dtype, device = values.dtype, values.device
    if dtype not in DTYPES:
        raise ValueError(f"gae takes float32 or float64 values, got {dtype}")
    if values.dim() != 2 or values.shape[0] == 0:
        raise ValueError(f"gae: values must be (T, B) with T >= 1, got {tuple(values.shape)}")
    T, B = values.shape
    _check(values, "values", (T, B), dtype, device)
    _check(rewards, "rewards", (T, B), dtype, device)
    _check(dones, "dones", (T, B), torch.bool, device)
    _check(last_value, "last_value", (B,), dtype, device)

    advantages = torch.empty((T, B), dtype=dtype, device=device)
    returns = torch.empty((T, B), dtype=dtype, device=device)
    if B == 0:
        return advantages, returns
    strides = (ctypes.c_longlong * 7)(*rewards.stride(), *values.stride(), *dones.stride(), last_value.stride(0))
    lib = _build.load(_build.gae_spec(), device)
    _build.launch(LAUNCH_NAME, lib.ngk_gae, rewards, values, dones, last_value, advantages, returns, strides, B, T,
                  float(gamma), float(gamma * lam), int(dtype == torch.float64), device=device)
    return advantages, returns
