"""Kernels a DDPG update runs on the device, from the trace (hand kernels and torch's)."""

from nanobench.readers import launches as read  # noqa: F401
