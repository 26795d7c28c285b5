"""Gymnasium-compatible env exports.

Mirrors the reference package layout (smart_nanogrid_gym/envs/__init__.py:1)
so downstream code can do either::

    from smart_nanogrid_gym_torch.envs import SmartNanogridEnv
    # or, with gymnasium installed:
    import smart_nanogrid_gym_torch.envs  # registers SmartNanogridTorchEnv-v0
    env = gymnasium.make("SmartNanogridTorchEnv-v0", number_of_chargers=4, ...)

The id differs from the JAX package's ``SmartNanogridEnv-v0``, so both
packages register side by side in one process.
"""

from ..compat.gym_adapter import SmartNanogridEnv

__all__ = ["SmartNanogridEnv"]

ENV_ID = "SmartNanogridTorchEnv-v0"

try:
    import gymnasium as _gymnasium

    if ENV_ID not in _gymnasium.registry:
        _gymnasium.register(
            id=ENV_ID,
            entry_point="smart_nanogrid_gym_torch.envs:SmartNanogridEnv",
            max_episode_steps=200,  # reference smart_nanogrid_gym/__init__.py:7
        )
except ImportError:  # gymnasium is optional
    pass
