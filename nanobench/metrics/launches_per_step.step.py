"""Kernels a vector-env step and the client's actor run on the device, from the trace."""

from nanobench.readers import launches as read  # noqa: F401
