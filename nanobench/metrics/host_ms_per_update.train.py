"""Mean ms of a PPO update in which the device was idle: the update's wall
time less its device-busy time (the learner's draws, GAE, the metrics)."""

from nanobench.readers import host_ms as read  # noqa: F401
