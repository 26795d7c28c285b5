"""Mean ms of an evaluation call in which the device was idle: the call's
wall time less its device-busy time (the entry, the param guard, the
wrappers' packing and launch)."""

from nanobench.readers import host_ms as read  # noqa: F401
