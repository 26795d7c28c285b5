"""Percent of the traced window of an evaluation cell in which the device was idle."""

from nanobench.readers import device_idle as read  # noqa: F401
