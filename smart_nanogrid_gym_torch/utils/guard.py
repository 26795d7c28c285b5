"""Failure detection and recovery for long training runs (port of ``utils/guard.py``).

The reference has no failure handling at all — its notion of error handling is
live ``breakpoint()`` traps on impossible states (SURVEY.md §5.3).  For
production-scale training this module provides:

- :func:`check_finite` — an all-finite reduction over the floating tensors
  of a nested state (one host read per device);
- :class:`TrainGuard` — wraps a train loop with NaN/Inf detection and
  automatic rollback to the last good checkpoint (elastic recovery: on
  corruption the loop resumes from the newest finite state with a fresh
  generator so the same divergence is not replayed).
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import torch

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint, tree_leaves


def check_finite(tree) -> bool:
    """True iff every floating tensor of the nested state is fully finite;
    integer tensors, numbers and generators are skipped."""
    flags: dict[torch.device, list[torch.Tensor]] = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            flags.setdefault(leaf.device, []).append(torch.isfinite(leaf).all())
    return all(bool(torch.stack(fs).all()) for fs in flags.values())


def reseeded(generator: torch.Generator, salt: int) -> torch.Generator:
    """A new generator on ``generator``'s device whose seed is the first 63
    bits of SHA-256 over ``generator.get_state()`` and ``salt`` (8 bytes,
    little-endian): the same restored generator and salt give the same
    stream, and ``generator`` itself is left as it is."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes() + salt.to_bytes(8, "little")).digest()
    fresh = torch.Generator(device=generator.device)
    fresh.manual_seed(int.from_bytes(digest[:8], "little") & (2 ** 63 - 1))
    return fresh


class TrainGuard:
    """Checkpointed NaN-guard around an arbitrary ``(state) -> (state, metrics)``
    train step.

    >>> guard = TrainGuard(step_fn, ckpt_dir, save_every=50)
    >>> state = guard.run(state, num_updates=1000)

    On a rollback the restored state's ``rng_field`` generator is replaced by
    :func:`reseeded` with the salt ``7919 + recoveries``, where the JAX guard
    folds ``7919 + recoveries`` into its key; the key stream itself is not
    reproduced.
    """

    def __init__(self, step_fn, ckpt_dir: str | None = None, save_every: int = 50,
                 rng_field: str = "generator", max_consecutive_failures: int = 20):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="nanogrid_guard_")
        self.save_every = save_every
        self.rng_field = rng_field
        self.max_consecutive_failures = max_consecutive_failures
        self.recoveries = 0       # lifetime count (telemetry)
        self._global_step = 0     # monotonic across run() calls (epoch reuse)

    def run(self, state, num_updates: int, *step_args, on_metrics=None):
        """Advance ``num_updates`` finite updates, rolling back to the newest
        finite checkpoint on NaN/Inf corruption.  Checkpoints are numbered by a
        monotonic global counter so reusing one guard across epochs never
        collides; transient blips that recover don't count toward divergence —
        only consecutive failures without new progress do."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if latest_step(self.ckpt_dir) is None:
            save_checkpoint(self.ckpt_dir, self._global_step, state)
        last_good = latest_step(self.ckpt_dir)
        target = self._global_step + num_updates
        consecutive_failures = 0
        while self._global_step < target:
            new_state, metrics = self.step_fn(state, *step_args)
            if check_finite((new_state, metrics)):
                state = new_state
                self._global_step += 1
                if on_metrics is not None:
                    on_metrics(self._global_step, metrics)
                if self._global_step % self.save_every == 0:
                    save_checkpoint(self.ckpt_dir, self._global_step, state)
                    last_good = self._global_step
                    consecutive_failures = 0
            else:
                # corruption: roll back to the last finite checkpoint and
                # reseed the generator so the identical divergence is not replayed
                self.recoveries += 1
                consecutive_failures += 1
                state = restore_checkpoint(self.ckpt_dir, last_good, state)
                if hasattr(state, self.rng_field):
                    generator = getattr(state, self.rng_field)
                    state = state._replace(**{self.rng_field: reseeded(generator, 7919 + self.recoveries)})
                self._global_step = last_good
                if consecutive_failures > self.max_consecutive_failures:
                    raise RuntimeError(
                        "TrainGuard: repeated recoveries without progress — "
                        "training is persistently diverging"
                    )
        return state
