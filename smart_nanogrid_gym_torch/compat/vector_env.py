"""Vectorized Gymnasium adapter backed by the batched engine (port of
``smart_nanogrid_gym_tpu/compat/vector_env.py``).

The reference has no vectorized execution (SB3 drives one raw env,
solvers/RL/ppo_train.py:89-92).  This adapter exposes the batched PyTorch
engine through the ``gymnasium.vector.VectorEnv`` interface, so vector-API
training code can drive thousands of envs with one batched step per call.
Numpy goes in and comes out at every step: that host round trip is the
adapter's contract.

Days are fixed-length, so every env finishes at once; on ``done`` the adapter
resets the whole batch with freshly generated days (vector-env autoreset:
the reset observation is returned with ``final_observation`` in infos), and
the battery SoC carries into the new day.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces as gym_spaces

    _VECTOR_BASE = gymnasium.vector.VectorEnv
except ImportError:
    gymnasium = None
    gym_spaces = None
    _VECTOR_BASE = object

from ..core.config import NanogridConfig
from ..core.env import SmartNanogridTorch
from ..core.params import make_params
from ..utils.profiling import span, spanned
from .gym_adapter import build_spaces


class VectorSmartNanogridEnv(_VECTOR_BASE):
    """``num_envs`` lockstep nanogrid environments on one device."""

    metadata = {"render_modes": []}

    def __init__(self, num_envs: int = 1024, seed: int = 0, dtype: torch.dtype = torch.float32,
                 device="cuda", **reference_kwargs):
        self.config = NanogridConfig.from_reference_kwargs(**reference_kwargs)
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.params = make_params(self.config, dtype, self.device)
        self.engine = SmartNanogridTorch(self.config)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._states = None

        if gym_spaces is not None:
            self.single_observation_space, self.single_action_space = build_spaces(self.config)
            space = self.single_observation_space
            self.observation_space = gym_spaces.Box(
                np.tile(space.low, (num_envs, 1)), np.tile(space.high, (num_envs, 1)), dtype=np.float32)
            self.action_space = gym_spaces.Box(
                np.tile(self.single_action_space.low, (num_envs, 1)),
                np.tile(self.single_action_space.high, (num_envs, 1)),
                dtype=np.float32,
            )

    @property
    def states(self):
        """The batched :class:`EnvState` of the current step (on the device)."""
        return self._states

    # -------------------------------------------------------------- VectorEnv --

    @spanned("vecenv.reset")
    def reset(self, seed=None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        batt = None if self._states is None else self._states.batt_soc
        self._states, obs = self.engine.reset_batch(self.params, self.num_envs, self._generator, batt_soc=batt)
        return obs.cpu().numpy(), {}

    def step(self, actions):
        actions = torch.as_tensor(np.asarray(actions, dtype=np.float32), device=self.device)
        res = self.engine.step_batch(self.params, self._states, actions, self._generator)
        self._states = res.state
        with span("to_host"):
            obs = res.obs.cpu().numpy()
            rewards = res.reward.cpu().numpy()
            dones = res.done.cpu().numpy()
        infos = {}
        if dones.all():
            # synchronized day end: autoreset with fresh days
            infos["final_observation"] = obs
            obs, _ = self.reset()
        return obs, rewards, dones, np.zeros_like(dones), infos

    def close(self):
        pass
