"""Philox4x32-10 in plain torch: the twin of the generator inside the
multiday kernels (``csrc/day_step.cuh``).

The JAX multiday kernels seed the TPU's hardware PRNG with ``seed +
program_id``, so the streams of two calls with nearby seeds overlap.  The
port's kernels use a counter-based Philox instead, keyed by ``(seed, global
env index)`` with the counter ``(day, t, draw kind, charger group)``: every
draw has its own address and no two envs or days share a stream.

Draw layout, for env ``b`` and day ``d`` (4 chargers per Philox block):

- ``u[t, k, n] = word(n % 4) of philox((d, t, k, n // 4), (seed, b))``;
- the day's PV-shift draw is ``word 0 of philox((d, T, 0, 0), (seed, b))``.

The collection kernel K2 draws one day per launch (``d = 0``; every update
passes a fresh seed) with the same generation draws, and two more kinds of
its own, so that they never overlap the generation draws (kinds 0-4):

- the action normals: ``n[t, a]`` is Box-Muller of ``u1`` = word ``a % 4`` of
  ``philox((0, t, 5, a // 4))`` and ``u2`` = the same word of
  ``philox((0, t, 6, a // 4))``: ``sqrt(-2 log(1 - u1)) · cos(2π u2)``, where
  ``1 - u1 ∈ (0, 1]`` guards the log (pallas_collect.py:262-268);
- the fresh day's PV shift ``⌊U · 181⌋ / 100`` (pallas_collect.py:276), ``U``
  = word 0 of ``philox((0, 0, 7, 0))``.

The DDPG collection kernel K9 draws its day with K2's kinds (generation
kinds 0-4 of day 0 and the PV shift of kind 7, :func:`collect_day_draws`),
so that K2 and K9 generate the same days at the same seed; its OU noise is an
explicit input.  Unlike the JAX kernels' ``seed + program_id`` streams
(pallas_collect.py:255), two seeds never share a stream.

A 32-bit word ``x`` becomes the uniform ``(x >> 8) · 2⁻²⁴`` in ``[0, 1)``,
exact in f32.  The arithmetic runs in int64 with the 32x32-bit products split
into 16-bit limbs, so every value is exact on any device.
"""

from __future__ import annotations

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
_INV24 = 1.0 / (1 << 24)
KIND_NORMAL_U1, KIND_NORMAL_U2, KIND_PV_SHIFT = 5, 6, 7
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of the 64-bit product ``m · x``."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    x_hi, x_lo = x >> 16, x & 0xFFFF
    mid = m_hi * x_lo + m_lo * x_hi                    # < 2**33
    lo_full = m_lo * x_lo + ((mid & 0xFFFF) << 16)     # < 2**33
    hi = m_hi * x_hi + (mid >> 16) + (lo_full >> 32)
    return hi, lo_full & MASK32


def philox4x32_10(ctr: tuple[torch.Tensor, ...], key: tuple[torch.Tensor, torch.Tensor]):
    """Philox4x32 with 10 rounds (Random123).  ``ctr``: 4 int64 tensors of
    32-bit values, ``key``: 2; all broadcast together.  Returns 4 words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
    return c0, c1, c2, c3


def to_uniform(word: torch.Tensor) -> torch.Tensor:
    """The top 24 bits of a 32-bit word as an f32 uniform in [0, 1)."""
    return (word >> 8).to(torch.float32) * _INV24


def day_uniforms(seed: int, day: int, batch: int, steps: int, num_chargers: int,
                 device: torch.device | str, env0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The multiday kernels' draws of one day for envs ``env0..env0+batch-1``.

    Returns ``(u (T, 5, N, B), u_pv (B,))`` as f32, ``u`` in the layout the
    explicit-uniform kernels take.  ``env0`` offsets the env index of the key,
    so that a slice of a global batch draws what the whole batch draws there.
    """
    groups = (num_chargers + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    env = torch.arange(env0, env0 + batch, **i64)
    key = (torch.full((), seed & MASK32, **i64), env)
    t = torch.arange(steps, **i64).view(steps, 1, 1, 1)
    k = torch.arange(5, **i64).view(1, 5, 1, 1)
    g = torch.arange(groups, **i64).view(1, 1, groups, 1)
    d = torch.full((), day, **i64)
    words = philox4x32_10((d, t, k, g), key)
    # (T, 5, G, B) x 4 words -> (T, 5, G*4, B), charger n = 4g + word
    u = torch.stack([w.expand(steps, 5, groups, batch) for w in words], dim=3)
    u = u.reshape(steps, 5, groups * 4, batch)[:, :, :num_chargers]
    zero = torch.zeros((), **i64)
    pv_word = philox4x32_10((d, torch.full((), steps, **i64), zero, zero), key)[0]
    return to_uniform(u), to_uniform(pv_word.expand(batch))


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two f32 uniforms in [0, 1), as K2 computes them."""
    return torch.sqrt(-2.0 * torch.log(1.0 - u1)) * torch.cos(TWO_PI_F32 * u2)


def collect_day_draws(seed: int, batch: int, steps: int, num_chargers: int,
                      device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor]:
    """The fresh day of K2 and K9 for envs ``0..batch-1``: ``(u (T, 5, N, B),
    u_pv (B,))`` as f32 (``u_pv`` before the PV-shift map ``⌊U · 181⌋ / 100``)."""
    u, _ = day_uniforms(seed, 0, batch, steps, num_chargers, device)
    i64 = dict(dtype=torch.int64, device=device)
    key = (torch.full((), seed & MASK32, **i64), torch.arange(batch, **i64))
    zero = torch.zeros((), **i64)
    pv_word = philox4x32_10((zero, zero, torch.full((), KIND_PV_SHIFT, **i64), zero), key)[0]
    return u, to_uniform(pv_word)


def collect_draws(seed: int, batch: int, steps: int, num_chargers: int, num_actions: int,
                  device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's draws for envs ``0..batch-1``: ``(u (T, 5, N, B), normals (T, A, B),
    u_pv (B,))`` as f32, the inputs K1 takes."""
    u, u_pv = collect_day_draws(seed, batch, steps, num_chargers, device)
    groups = (num_actions + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    key = (torch.full((), seed & MASK32, **i64), torch.arange(batch, **i64))
    zero = torch.zeros((), **i64)
    t = torch.arange(steps, **i64).view(steps, 1, 1)
    g = torch.arange(groups, **i64).view(1, groups, 1)

    def words(kind):  # (T, G*4, B) -> (T, A, B), action a = 4g + word
        w = philox4x32_10((zero, t, torch.full((), kind, **i64), g), key)
        w = torch.stack([x.expand(steps, groups, batch) for x in w], dim=2)
        return to_uniform(w.reshape(steps, groups * 4, batch)[:, :num_actions])

    normals = box_muller(words(KIND_NORMAL_U1), words(KIND_NORMAL_U2))
    return u, normals, u_pv
