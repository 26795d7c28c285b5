"""Percent of the traced window of the DDPG training cell in which the device was idle."""

from nanobench.readers import device_idle as read  # noqa: F401
