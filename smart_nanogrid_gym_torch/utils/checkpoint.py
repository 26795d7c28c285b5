"""Checkpoint/resume for learner states (port of ``utils/checkpoint.py``).

The layout is the JAX package's: a checkpoint is the directory
``<directory>/<step>`` (numbered like the reference's ``{timesteps*epoch}``
zips), with a ``config.json`` sidecar beside the steps naming the env config,
byte for byte what the JAX package writes.  The payload is
``<directory>/<step>/state.pt`` in place of orbax: the state's leaves in
order, written by ``torch.save`` and read back with ``torch.load(weights_only=
True)`` into the structure of a target state, as orbax restores into a
target pytree.

A state is any nesting of NamedTuples, lists, tuples and dicts whose leaves
are tensors, Python numbers (or None) and ``torch.Generator``s: the
learners' ``PPOTrainState`` and ``DDPGTrainState`` (Adam counts, the replay
buffer's ``insert_pos``/``filled``, the host generator) or a bare list of
parameter leaves.  Tensors come back bit for bit on the target's devices, a
generator as a new generator on the target generator's device holding the
saved ``get_state()``, a number as saved.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

STATE_FILE = "state.pt"


def _config_metadata(env_config) -> dict:
    d = dataclasses.asdict(env_config)
    d["penalty_mode"] = int(d["penalty_mode"])
    return d


def _is_value(x) -> bool:
    return x is None or isinstance(x, (bool, int, float))


def tree_leaves(tree) -> list:
    """The leaves of a state in order: tensors, generators and numbers."""
    if isinstance(tree, (torch.Tensor, torch.Generator)) or _is_value(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):  # NamedTuples included
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    raise TypeError(f"a checkpointed state holds tensors, generators and numbers, not {type(tree).__name__}")


def _kind(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    return "generator" if isinstance(leaf, torch.Generator) else "value"


def _stored(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf.get_state() if isinstance(leaf, torch.Generator) else leaf


def _restored(target, kind: str, saved, index: int):
    if kind != _kind(target):
        raise ValueError(f"leaf {index}: the checkpoint holds a {kind}, the target a {_kind(target)}")
    if kind == "tensor":
        if saved.shape != target.shape or saved.dtype != target.dtype:
            raise ValueError(f"leaf {index}: the checkpoint holds {saved.dtype} {tuple(saved.shape)}, "
                             f"the target {target.dtype} {tuple(target.shape)}")
        return saved.to(target.device)
    if kind == "generator":
        generator = torch.Generator(device=target.device)
        generator.set_state(saved)
        return generator
    return saved


def _rebuild(target, leaves):
    """``target``'s structure with its leaves taken in order from the iterator ``leaves``."""
    if isinstance(target, (torch.Tensor, torch.Generator)) or _is_value(target):
        return next(leaves)
    if isinstance(target, dict):
        return type(target)((key, _rebuild(target[key], leaves)) for key in target)
    children = [_rebuild(sub, leaves) for sub in target]
    if hasattr(target, "_fields"):  # NamedTuple
        return type(target)(*children)
    return type(target)(children)


def save_checkpoint(directory: str, step: int, train_state, env_config=None) -> str:
    """Save a train state under ``directory/<step>`` (numbered like the
    reference's ``{timesteps*epoch}`` zips)."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, str(step))
    os.makedirs(path, exist_ok=True)
    leaves = tree_leaves(train_state)
    payload = {"kinds": [_kind(x) for x in leaves], "leaves": [_stored(x) for x in leaves]}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if env_config is not None:
        with open(os.path.join(directory, "config.json"), "w") as fp:
            json.dump(_config_metadata(env_config), fp, indent=2)
    return path


def restore_checkpoint(directory: str, step: int, target_state):
    """Restore into the structure of ``target_state`` (a state of the same
    shape; its tensors' devices are the restored tensors' devices).  Raises
    ``FileNotFoundError`` when the step holds no ``state.pt`` and
    ``ValueError`` when the saved leaves do not fit the target."""
    path = os.path.join(os.path.abspath(directory), str(step), STATE_FILE)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    targets = tree_leaves(target_state)
    kinds, saved = payload["kinds"], payload["leaves"]
    if len(saved) != len(targets):
        raise ValueError(f"the checkpoint holds {len(saved)} leaves, the target {len(targets)}")
    leaves = [_restored(t, k, s, i) for i, (t, k, s) in enumerate(zip(targets, kinds, saved))]
    return _rebuild(target_state, iter(leaves))


def latest_step(directory: str) -> int | None:
    """Largest numbered checkpoint in a directory (reference evaluator picks a
    specific number, solvers/evaluator.py:49-51; we expose both)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None
