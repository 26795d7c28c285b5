"""smart_nanogrid_gym_torch — the smart-nanogrid engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`smart_nanogrid_gym_tpu` (the JAX package, kept beside it as the
reference).  The layout mirrors it: ``core/`` is the plain-PyTorch engine,
``ops/`` holds the kernels with their plain twins, ``solvers/`` the controllers
and the evaluator.  The JAX-free modules of the reference package
(``core.config``, ``core.prices``, ``core.solar`` and the irradiance data) are
shared as they are; nothing here imports JAX.

Every function takes its tensors' device from its arguments: there is no
automatic device pick.  A kernel wrapper runs its CUDA kernel on CUDA tensors
and its plain twin on CPU tensors.
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
        from smart_nanogrid_gym_tpu.core import config as _config

        return getattr(_config, name)
    if name in __all__:
        from . import core as _core

        return getattr(_core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
