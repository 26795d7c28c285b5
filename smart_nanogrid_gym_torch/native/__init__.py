"""ctypes bindings for the native C++ runtime (``nanogrid_native.cpp``),
the port of ``smart_nanogrid_gym_tpu/native``.

Provides:

- :func:`generate_schedule_native`: a bit-exact replay of the reference's
  day-generation RNG stream from a numpy-style integer seed (the reference's
  ``np.random.seed(seed)`` global-MT19937 stream, charging_station.py:200-279);
- :class:`NativeEngine`: a standalone CPU serving engine with the exact
  environment semantics, no Python or numpy in the step loop;
- :class:`NativeBatchEngine`: a fleet of them stepped in lockstep (OpenMP).

These are host engines by design, as in the JAX package: they take numpy
arrays in and give numpy arrays out, and they are not a CPU fallback of any
kernel.  :func:`..core.generate.schedule_from_reference_seed` moves a native
day onto the card.

The library is built at first use by this directory's ``Makefile`` (``make
OUT=...``, with ``g++``) from the port's own copy of the source, into
``build/torch_native/`` at the root of the checkout, named by a digest of the
source, the Makefile and the host CPU (``-march=native``).  A missing ``make``
or ``g++`` or a failed build raises; ``-ffp-contract=off`` is required,
because without it the schedules stop being bit-equal to numpy's separately
rounded arithmetic.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "nanogrid_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
REQUIRED_FLAG = "-ffp-contract=off"

_lib = None


def compiler_flags() -> list[str]:
    """The ``CXXFLAGS`` of the Makefile; raises if they lose ``-ffp-contract=off``."""
    text = (NATIVE_DIR / "Makefile").read_text()
    match = re.search(r"^CXXFLAGS\s*\?=\s*(.+)$", text, re.M)
    if match is None:
        raise RuntimeError(f"{NATIVE_DIR / 'Makefile'} has no CXXFLAGS line")
    flags = match.group(1).split()
    if REQUIRED_FLAG not in flags:
        raise RuntimeError(f"the native build needs {REQUIRED_FLAG} (bit-equal schedules); CXXFLAGS are {flags}")
    return flags


def _host_cpu() -> bytes:
    """The host's CPU flags, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as fp:
            return next((line for line in fp if line.startswith(b"flags")), b"")
    except OSError:
        return os.uname().machine.encode()


def library_path() -> Path:
    digest = hashlib.sha256((NATIVE_DIR / "Makefile").read_bytes())
    digest.update(SOURCE.read_bytes())
    digest.update(_host_cpu())
    return BUILD_DIR / f"libnanogrid_native_{digest.hexdigest()[:12]}.so"


def build() -> tuple[Path, float]:
    """Run the Makefile's rule unless the library exists; returns its path and
    the seconds spent compiling.  Raises without ``make`` or ``g++``, when the
    compiler fails, or when the command make ran lacks ``-ffp-contract=off``
    (the environment's ``CXX``/``CXXFLAGS`` are not passed on)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    for tool in ("make", "g++"):
        if shutil.which(tool) is None:
            raise RuntimeError(f"the native runtime needs {tool} on PATH to build nanogrid_native.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    env = {k: v for k, v in os.environ.items() if k not in ("CXX", "CXXFLAGS", "MAKEFLAGS", "MFLAGS")}
    cmd = ["make", "--no-print-directory", "-C", str(NATIVE_DIR), f"OUT={tmp}", "CXX=g++"]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    seconds = time.perf_counter() - start
    if proc.returncode != 0 or REQUIRED_FLAG not in proc.stdout.split():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path, seconds


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    D = ctypes.POINTER(ctypes.c_double)
    lib.ng_generate_schedule.restype = ctypes.c_int
    lib.ng_generate_schedule.argtypes = [
        ctypes.c_uint32, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int] + [D] * 8
    lib.ng_engine_new.restype = ctypes.c_void_p
    lib.ng_engine_new.argtypes = [
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, D, ctypes.c_int, D, D, ctypes.c_int]
    lib.ng_engine_free.argtypes = [ctypes.c_void_p]
    lib.ng_engine_obs_dim.restype = ctypes.c_int
    lib.ng_engine_obs_dim.argtypes = [ctypes.c_void_p]
    lib.ng_engine_reset.argtypes = [ctypes.c_void_p] + [D] * 8 + [ctypes.c_double, ctypes.c_double, D]
    lib.ng_engine_step.restype = ctypes.c_int
    lib.ng_engine_step.argtypes = [ctypes.c_void_p, D, D, D, D, D]
    lib.ng_batch_new.restype = ctypes.c_void_p
    lib.ng_batch_new.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, D, ctypes.c_int, D, D, ctypes.c_int]
    lib.ng_batch_free.argtypes = [ctypes.c_void_p]
    lib.ng_batch_obs_dim.restype = ctypes.c_int
    lib.ng_batch_obs_dim.argtypes = [ctypes.c_void_p]
    lib.ng_batch_reset_env.argtypes = [ctypes.c_void_p, ctypes.c_int] + [D] * 8 + [
        ctypes.c_double, ctypes.c_double, D]
    lib.ng_batch_step.restype = ctypes.c_int
    lib.ng_batch_step.argtypes = [ctypes.c_void_p] + [D] * 6
    _lib = lib
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


SCHEDULE_FIELDS = (
    "occupancy", "capacity", "requested_soc", "soc_init",
    "is_arrival", "dep_obs", "mask_departing", "mask_departing3",
)


def generate_schedule_native(
    seed: int,
    num_chargers: int,
    time_interval: float = 1.0,
    table_len: int | None = None,
    different_capacities: bool = True,
    requested_soc: bool = False,
) -> dict[str, np.ndarray]:
    """Generate one day bit-identically to the reference under
    ``np.random.seed(seed)``.  Returns a dict of ``(N, L)`` float64 tables."""
    lib = _load()
    T = int(round(24.0 / time_interval))
    L = table_len or (T + 1)
    arrays = {name: np.zeros((num_chargers, L), dtype=np.float64) for name in SCHEDULE_FIELDS}
    rc = lib.ng_generate_schedule(
        seed, num_chargers, time_interval, L,
        int(different_capacities), int(requested_soc),
        *[_ptr(arrays[name]) for name in SCHEDULE_FIELDS],
    )
    if rc != 0:
        raise RuntimeError(f"ng_generate_schedule failed with {rc}")
    return arrays


INFO_FIELDS = (
    "total_cost", "grid_energy_cost", "grid_energy", "grid_power",
    "utilized_solar_energy", "total_penalty", "total_battery_penalty",
    "total_vehicle_penalty", "battery_action", "total_charging_power",
    "total_discharging_power", "battery_power_value",
    "battery_calculated_power_value", "battery_state_of_charge",
    "initial_battery_state_of_charge",
    "discharging_nonexistent_vehicles_penalty",
)


def _host_tables(schedule) -> list[np.ndarray]:
    """The eight ``(N, L)`` f64 tables of a dict (per
    :func:`generate_schedule_native`) or of one env's ``DaySchedule``."""
    if not isinstance(schedule, dict):
        schedule = {name: getattr(schedule, name) for name in SCHEDULE_FIELDS}
    out = []
    for name in SCHEDULE_FIELDS:
        x = schedule[name]
        if hasattr(x, "detach"):  # a torch tensor, on any device
            x = x.detach().cpu().numpy()
        x = np.asarray(x, dtype=np.float64)
        out.append(np.ascontiguousarray(x.reshape(x.shape[-2:])))
    return out


def _check_lookahead(config) -> None:
    # the obs lookahead follows config (the reference's NUMBER_OF_HOURS_AHEAD
    # counts timesteps, SURVEY.md Q11); the sparse-penalty 3-step window is
    # fixed (Q10: the reference's check ignores its n)
    if config.lookahead >= config.steps_per_day:
        raise ValueError(f"lookahead {config.lookahead} must stay within the padded "
                         f"2-day tables (< {config.steps_per_day} timesteps)")


class NativeEngine:
    """Standalone CPU environment engine (exact reference semantics), a host
    engine: numpy in, numpy out."""

    def __init__(self, config, params=None):
        """``config``: a ``core.NanogridConfig``.  ``params``: an optional
        ``core.NanogridParams`` (unbatched; its price and solar tables are
        copied to the host); when omitted the tables are built with numpy."""
        lib = _load()
        self.config = config
        if params is None:
            price, rad, solar = _build_tables(config)
        else:
            price, rad, solar = (np.ascontiguousarray(x.detach().cpu().numpy().reshape(-1), dtype=np.float64)
                                 for x in (params.price, params.rad_norm, params.solar_power))
        _check_lookahead(config)
        self._h = lib.ng_engine_new(
            config.num_chargers, config.time_interval,
            int(config.pv_system), int(config.battery_system),
            int(config.vehicle_to_everything), int(config.penalty_mode),
            int(config.lookahead),
            _ptr(price), len(price), _ptr(rad), _ptr(solar), len(solar),
        )
        self._keepalive = (price, rad, solar)
        self._lib = lib
        self.obs_dim = lib.ng_engine_obs_dim(self._h)
        self.num_actions = config.num_chargers + int(config.battery_system)
        self._obs = np.zeros(self.obs_dim, dtype=np.float64)
        self._reward = np.zeros(1, dtype=np.float64)
        self._info = np.zeros(16, dtype=np.float64)
        self._powers = np.zeros(config.num_chargers, dtype=np.float64)

    def reset(self, schedule, batt_soc: float = -1.0, pv_shift: float = 1.0):
        """Reset with schedule tables (a dict per :func:`generate_schedule_native`
        or one env's ``core.DaySchedule``).  ``batt_soc < 0`` keeps the
        carried battery state."""
        tables = _host_tables(schedule)
        self._lib.ng_engine_reset(
            self._h, *[_ptr(a) for a in tables],
            ctypes.c_double(batt_soc), ctypes.c_double(pv_shift), _ptr(self._obs),
        )
        return self._obs.copy()

    def step(self, actions):
        actions = np.ascontiguousarray(np.asarray(actions, dtype=np.float64))
        done = self._lib.ng_engine_step(
            self._h, _ptr(actions), _ptr(self._obs), _ptr(self._reward),
            _ptr(self._info), _ptr(self._powers),
        )
        info = dict(zip(INFO_FIELDS, self._info.tolist()))
        info["charger_power_values"] = self._powers.copy()
        return self._obs.copy(), float(self._reward[0]), bool(done), info

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.ng_engine_free(self._h)
            self._h = None


class NativeBatchEngine:
    """Fleet of independent native envs stepped in lockstep (OpenMP).

    The serving counterpart of :class:`NativeEngine`: B envs behind one
    ``step_batch`` call, spread across the host's cores in C++, no Python in
    the per-env loop.  Each env steps as a :class:`NativeEngine` would
    (tests/test_torch_native.py pins the batch against B individual engines).
    A host engine: numpy in, numpy out."""

    def __init__(self, config, num_envs: int):
        lib = _load()
        self.config = config
        self.num_envs = num_envs
        price, rad, solar = _build_tables(config)
        _check_lookahead(config)
        self._h = lib.ng_batch_new(
            num_envs, config.num_chargers, config.time_interval,
            int(config.pv_system), int(config.battery_system),
            int(config.vehicle_to_everything), int(config.penalty_mode),
            int(config.lookahead),
            _ptr(price), len(price), _ptr(rad), _ptr(solar), len(solar),
        )
        self._keepalive = (price, rad, solar)
        self._lib = lib
        self.obs_dim = lib.ng_batch_obs_dim(self._h)
        self.num_actions = config.num_chargers + int(config.battery_system)
        B, N = num_envs, config.num_chargers
        self._obs = np.zeros((B, self.obs_dim), dtype=np.float64)
        self._rewards = np.zeros(B, dtype=np.float64)
        self._dones = np.zeros(B, dtype=np.float64)
        self._infos = np.zeros((B, 16), dtype=np.float64)
        self._powers = np.zeros((B, N), dtype=np.float64)

    def reset(self, schedules, batt_soc: float = -1.0, pv_shifts=None):
        """Reset every env with its own schedule (dicts per
        :func:`generate_schedule_native`, or one-env ``DaySchedule`` objects)."""
        if pv_shifts is None:
            pv_shifts = np.ones(self.num_envs)
        for i, schedule in enumerate(schedules):
            tables = _host_tables(schedule)
            self._lib.ng_batch_reset_env(
                self._h, i, *[_ptr(a) for a in tables],
                ctypes.c_double(batt_soc), ctypes.c_double(float(pv_shifts[i])),
                _ptr(self._obs),
            )
        return self._obs.copy()

    def step_batch(self, actions):
        """Step all envs: actions (B, A) -> (obs (B, D), rewards (B,),
        dones (B,), infos dict of (B,) arrays + charger powers (B, N))."""
        actions = np.ascontiguousarray(np.asarray(actions, dtype=np.float64))
        if actions.shape != (self.num_envs, self.num_actions):
            raise ValueError(f"actions must be {(self.num_envs, self.num_actions)}, got {actions.shape}")
        self._lib.ng_batch_step(
            self._h, _ptr(actions), _ptr(self._obs), _ptr(self._rewards),
            _ptr(self._dones), _ptr(self._infos), _ptr(self._powers),
        )
        infos = {name: self._infos[:, k].copy() for k, name in enumerate(INFO_FIELDS)}
        infos["charger_power_values"] = self._powers.copy()
        return (self._obs.copy(), self._rewards.copy(),
                self._dones.astype(bool), infos)

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.ng_batch_free(self._h)
            self._h = None


def _build_tables(config):
    """The price, normalised-irradiance and solar-power tables as contiguous
    f64 numpy arrays (the port's ``core.prices`` and ``core.solar``)."""
    from ..core import prices as prices_mod, solar as solar_mod

    price_table, _ = prices_mod.build_price_table(config.price_model, config.price_table_len)
    if config.pv_system:
        irr, solar_power, max_rad = solar_mod.build_solar_tables(config.time_interval, config.steps_per_day)
        rad_norm = np.asarray(irr) / max_rad
    else:
        solar_power = np.zeros(config.solar_table_len)
        rad_norm = np.zeros(config.solar_table_len)
    return (np.ascontiguousarray(price_table, dtype=np.float64),
            np.ascontiguousarray(rad_norm, dtype=np.float64),
            np.ascontiguousarray(solar_power, dtype=np.float64))
