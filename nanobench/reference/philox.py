"""Philox4x32-10 (Random123) in int64 torch arithmetic, exact on any
device, and the draw layout the program documents for its day kernels:
key ``(seed, env)``, counter ``(day, t, kind, charger group)``, a group of
four chargers per block, a word ``x`` read as the uniform ``(x >> 8)·2⁻²⁴``.

Kinds 0-4 are a step's arrival, SoC, capacity, requested SoC and departure
draws; a multiday day's PV shift is word 0 of ``(day, T, 0, 0)``; a
collection day (day 0) draws its action normals from kinds 5 and 6
(Box-Muller) and its PV shift from word 0 of ``(0, 0, 7, 0)``.
"""

from __future__ import annotations

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
TWO_PI = float(np.float32(2.0 * np.pi))


def _mulhilo(m: int, x: torch.Tensor):
    m_hi, m_lo = m >> 16, m & 0xFFFF
    x_hi, x_lo = x >> 16, x & 0xFFFF
    mid = m_hi * x_lo + m_lo * x_hi
    lo = m_lo * x_lo + ((mid & 0xFFFF) << 16)
    return m_hi * x_hi + (mid >> 16) + (lo >> 32), lo & MASK


def philox(ctr, key):
    """Four 32-bit words of Philox4x32-10 for counters ``ctr`` (4 int64
    tensors) and keys ``key`` (2), broadcast together."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def uniform(word: torch.Tensor) -> torch.Tensor:
    return (word >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _words(seed: int, day, t, kind, group, env):
    i64 = dict(dtype=torch.int64, device=env.device)
    key = (torch.full((), seed & MASK, **i64), env)
    return philox((day, t, kind, group), key)


def day_draws(seed: int, day: torch.Tensor, env: torch.Tensor, T: int, N: int):
    """The generation draws of lanes ``(day[l], env[l])``: ``u (T, 5, L, N)``
    and the multiday PV-shift uniform ``(L,)``, f32."""
    i64 = dict(dtype=torch.int64, device=env.device)
    G = (N + 3) // 4
    t = torch.arange(T, **i64).view(T, 1, 1, 1)
    k = torch.arange(5, **i64).view(1, 5, 1, 1)
    g = torch.arange(G, **i64).view(1, 1, G, 1)
    w = _words(seed, day, t, k, g, env)          # (T, 5, G, L) each
    u = torch.stack([x.expand(T, 5, G, env.numel()) for x in w], dim=3)  # (T, 5, G, 4, L)
    u = u.reshape(T, 5, 4 * G, env.numel())[:, :, :N].permute(0, 1, 3, 2)
    zero = torch.zeros((), **i64)
    pv = _words(seed, day, torch.full((), T, **i64), zero, zero, env)[0]
    return uniform(u), uniform(pv.expand(env.numel()))


def collect_draws(seed: int, env: torch.Tensor, T: int, N: int, A: int):
    """A collection day's draws: ``u (T, 5, L, N)``, the action normals
    ``(T, L, A)`` and the PV-shift uniform ``(L,)``, f32."""
    i64 = dict(dtype=torch.int64, device=env.device)
    zero = torch.zeros((), **i64)
    u, _ = day_draws(seed, zero, env, T, N)
    pv = uniform(_words(seed, zero, zero, torch.full((), 7, **i64), zero, env)[0])
    G = (A + 3) // 4
    t = torch.arange(T, **i64).view(T, 1, 1)
    g = torch.arange(G, **i64).view(1, G, 1)

    def kind(k):
        w = _words(seed, zero, t, torch.full((), k, **i64), g, env)
        w = torch.stack([x.expand(T, G, env.numel()) for x in w], dim=2)  # (T, G, 4, L)
        return uniform(w.reshape(T, 4 * G, env.numel())[:, :A].permute(0, 2, 1))

    u1, u2 = kind(5), kind(6)
    normals = torch.sqrt(-2.0 * torch.log(1.0 - u1)) * torch.cos(TWO_PI * u2)
    return u, normals, pv.expand(env.numel())
