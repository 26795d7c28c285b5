"""Reference-compatible adapters: the single-env gym adapter and the batched
vector env."""

from .gym_adapter import SmartNanogridEnv
from .vector_env import VectorSmartNanogridEnv

__all__ = ["SmartNanogridEnv", "VectorSmartNanogridEnv"]
