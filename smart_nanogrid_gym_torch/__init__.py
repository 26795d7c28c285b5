"""smart_nanogrid_gym_torch — the smart-nanogrid engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`smart_nanogrid_gym_tpu` (the JAX package, kept beside it as the
reference).  The layout mirrors it: ``core/`` is the plain-PyTorch engine,
``ops/`` holds the kernels with their plain twins, ``solvers/`` the
controllers, the evaluator and the PPO and DDPG learners, ``compat/`` the gym
adapter and the vector env (``envs/`` registers the adapter with gymnasium).
The port keeps its own copies of the JAX package's JAX-free
``core/config.py``, ``core/prices.py``, ``core/solar.py`` and the irradiance
data: nothing here imports JAX or the JAX package.

Every function takes its tensors' device from its arguments; the entry
points that build their own tensors (``make_params``, the learners, the
adapters) default to the card and take ``device="cpu"`` where the caller
asks for it.  A kernel wrapper runs its CUDA kernel on CUDA tensors and its
plain twin on CPU tensors; it never falls back from one to the other.
"""

__version__ = "0.1.0"

__all__ = [
    "NanogridConfig",
    "NanogridParams",
    "PenaltyMode",
    "SmartNanogridTorch",
    "make_params",
]


def __getattr__(name):
    if name in ("NanogridConfig", "PenaltyMode"):
        from .core import config as _config

        return getattr(_config, name)
    if name in __all__:
        from . import core as _core

        return getattr(_core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
