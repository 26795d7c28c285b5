"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles each library at first use, for ``sm_90a``, from the entry
sources of its kind (``KINDS``): ``kernels`` (``kernels.cu``: the day
kernels K1, K2, K5-K9, K11a/K11b) once per static configuration (charger
count, config flags, actor hidden sizes and kind: the PPO actor's library
holds K5/K6, K1/K2 and K11b, the DDPG actor's K5/K6 ``actor="ddpg"`` and K9,
both K7/K8 and K11a), ``sweep`` (``sweep.cu``: the PPO update sweep K3/K4)
and ``ddpg_sweep`` (``ddpg_sweep.cu``: the DDPG update sweep K10) once per
network shape, ``engine`` (``generate.cu`` with ``engine_step.cu``: the
plain engine's day generation and step) once per static configuration, and
``gae`` (``gae.cu``: the PPO learner's advantage estimation) once.  A
library is named by a :class:`Spec`, its kind and ``-D`` values, which the
``*_spec`` functions make.  The bf16 operand options (K6's ``mlp_dtype``,
the sweeps' ``matmul_dtype``) are launch arguments of the same libraries.
Libraries land in ``build/torch_kernels/`` at the root of the checkout,
named by the spec and a digest of the sources and nvcc flags, which is
computed once per process: an edited source rebuilds in a new process.
They are loaded with ``ctypes`` and their entry points bound to the
signatures of ``KINDS``; every launch goes on PyTorch's current stream and
its ``cudaGetLastError()`` is checked.

The launch contract every wrapper keeps is here too: :func:`kernel_device`
routes CPU tensors to the plain twin and CUDA tensors to the kernel,
:func:`bf16_operands` reads the bf16 operand option, and
``MAX_SHARED_BYTES`` bounds a block's shared memory.

``launch_counts`` counts the launches of each kernel by name: a wrapper adds
one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

from ..core.config import NanogridConfig
from ..utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("operand.cuh", "day_step.cuh", "kernels.cu", "ppo_sweep.cuh", "sweep.cu", "ddpg_sweep.cuh",
           "ddpg_sweep.cu", "generate.cu", "engine_step.cu", "gae.cu")
# --fmad=false: no FMA contraction, so the kernels round like their twins;
# IEEE division stays on (no --use_fast_math).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
DEFAULT_HIDDEN = (64, 64)
ACTORS = {"ppo": 0, "ddpg": 1}
MAX_SHARED_BYTES = 232_448  # dynamic shared memory one H100 block may use

launch_counts: Counter = Counter()

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LL, _D = ctypes.c_longlong, ctypes.c_double
_LLP = ctypes.POINTER(ctypes.c_longlong)


class Kind(NamedTuple):
    """A kind of library: its entry sources, compiled by one nvcc run into
    one library; the C entry points every library of the kind exports, each
    with its argument types (``int`` returned); and, for the day kernels,
    the further entry points by the actor kind ``NG_ACTOR``."""

    sources: tuple[str, ...]
    signatures: dict[str, tuple]
    by_actor: tuple[dict[str, tuple], ...] = ()


KINDS = {
    "kernels": Kind(("kernels.cu",), {
        "ngk_block_actor": (),
        "ngk_collect_weights_size": (),
        "ngk_collect_smem_floats": (),
        "ngk_collect_envs": (),
        "ngk_k6_weights_size": (_I,),
        "ngk_k6_smem_floats": (_I,),
        "ngk_k6_pad": (_I,),
        "ngk_rbc_lanes": (_I,),
        "ngk_rbc_lane_threads": (),
        "ngk_rbc_envs": (),
        "ngk_rbc_ring_depth": (),
        "ngk_rbc_ring_floats": (),
        "ngk_gen_rbc_ring_depth": (),
        "ngk_gen_rbc_ring_floats": (),
        "ngk_gen_rbc_day": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        "ngk_gen_rbc_multiday": (_P, _P, _I, _P, _U, _I, _P, _I, _I, _I, _I, _I, _F, _P),
        "ngk_rbc_day_rollout": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
        "ngk_gen_policy_day": (_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        # ..., dt, bf16, stream
        "ngk_gen_policy_multiday": (_P, _P, _I, _P, _I, _P, _U, _I, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    }, by_actor=(
        {  # NG_ACTOR 0, the PPO actor: K11b, K1/K2
            "ngk_k11b_smem_floats": (),
            "ngk_policy_day_rollout": (_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
            "ngk_ppo_collect_day": (_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _F, _P),
            "ngk_ppo_collect_day_seeded": (_P, _P, _I, _P, _I, _P, _U, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _I, _F, _P),
        },
        {  # NG_ACTOR 1, the DDPG actor: K9
            "ngk_ddpg_collect_day": (_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _F, _P),
            "ngk_ddpg_collect_day_seeded": (_P, _P, _I, _P, _I, _P, _U, _P, _P, _P, _P, _P, _P, _P, _P,
                                            _I, _I, _I, _I, _I, _F, _P),
        },
    )),
    "sweep": Kind(("sweep.cu",), {
        "ngk_sweep_params_size": (),
        "ngk_sweep_slices": (),
        "ngk_sweep_grid_blocks": (),
        "ngk_ppo_sweep": (_P, _P, _P, _P),  # ptrs, ints, floats, stream
    }),
    "ddpg_sweep": Kind(("ddpg_sweep.cu",), {
        "ngk_ddpg_actor_size": (),
        "ngk_ddpg_critic_size": (),
        "ngk_ddpg_scratch_floats": (_I,),
        "ngk_ddpg_grid_blocks": (),
        "ngk_ddpg_sweep": (_P, _P, _P, _P),
    }),
    "engine": Kind(("generate.cu", "engine_step.cu"), {
        # u, the seven params, out, strides, B, T, L, k4, k10, k1, f64, stream
        "ngk_generate_day": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _I, _I, _I, _P),
        # operands, their strides, rows, soc, obs, ints, done, B, T, L, price_len, rad_len, dt, f64, drawn, stream
        "ngk_engine_step": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _D, _I, _I, _P),
    }),
    "gae": Kind(("gae.cu",), {
        # rewards, values, dones, last value, advantages, returns, strides, B, T, gamma, gamma * lam, f64, stream
        "ngk_gae": (_P, _P, _P, _P, _P, _P, _LLP, _LL, _I, _D, _D, _I, _P),
    }),
}


class Spec(NamedTuple):
    """A library: its kind (a key of ``KINDS``) and the ``-D`` values it is
    built with."""

    kind: str
    flags: dict[str, int]


# the loaded libraries by their specs: a launch after the first reads no file
_LIBRARIES: dict[tuple, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def config_spec(config: NanogridConfig, hidden: tuple[int, int] = DEFAULT_HIDDEN, actor: str = "ppo") -> Spec:
    """The day-kernel library for a static configuration and an actor."""
    if actor not in ACTORS:
        raise ValueError(f"actor must be one of {tuple(ACTORS)}, got {actor!r}")
    return Spec("kernels", {
        "NG_N": config.num_chargers,
        "NG_PV": int(config.pv_system),
        "NG_BATT": int(config.battery_system),
        "NG_PMODE": int(config.penalty_mode),
        "NG_DIFF_CAPS": int(config.different_battery_capacities),
        "NG_REQ_SOC": int(config.requested_state_of_charge),
        "NG_H1": int(hidden[0]),
        "NG_H2": int(hidden[1]),
        "NG_ACTOR": ACTORS[actor],
    })


def sweep_spec(F: int, A: int, H1: int, H2: int) -> Spec:
    """The PPO sweep library for a network shape."""
    return Spec("sweep", {"NG_F": int(F), "NG_A": int(A), "NG_H1": int(H1), "NG_H2": int(H2)})


def ddpg_sweep_spec(F: int, A: int, H1: int, H2: int) -> Spec:
    """The DDPG sweep library for a network shape."""
    return Spec("ddpg_sweep", {"NG_F": int(F), "NG_A": int(A), "NG_H1": int(H1), "NG_H2": int(H2)})


def engine_spec(config: NanogridConfig) -> Spec:
    """The plain-engine library (the day generation and the step) for a
    static configuration."""
    return Spec("engine", {
        "NG_N": config.num_chargers,
        "NG_DIFF_CAPS": int(config.different_battery_capacities),
        "NG_REQ_SOC": int(config.requested_state_of_charge),
        "NG_PV": int(config.pv_system),
        "NG_BATT": int(config.battery_system),
        "NG_PMODE": int(config.penalty_mode),
        "NG_LOOKAHEAD": int(config.lookahead),
        "NG_CAST_OBS": int(config.cast_obs_to_f32),
    })


def gae_spec() -> Spec:
    """The advantage-estimation library: it depends on no static
    configuration."""
    return Spec("gae", {})


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (CUDA_HOME or PATH)")


def _compile(spec: Spec, src_dir: Path, out: Path, log: Path) -> float:
    """Compile ``spec``'s entry sources under ``src_dir`` into ``out``;
    returns the seconds nvcc took.  The command and the ptxas report go to
    ``log``; raises when nvcc fails."""
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in spec.flags.items()), "-o", str(out),
           *(str(src_dir / name) for name in KINDS[spec.kind].sources)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {spec} in {src_dir}:\n{proc.stderr[-4000:]}")
    return seconds


def _open(path: Path, spec: Spec) -> ctypes.CDLL:
    """The library at ``path`` with the entry points of ``spec``'s kind bound."""
    kind = KINDS[spec.kind]
    entries = {**kind.signatures, **(kind.by_actor[spec.flags["NG_ACTOR"]] if kind.by_actor else {})}
    lib = ctypes.CDLL(str(path))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def source_digest() -> str:
    """The digest of the nvcc flags and the ``csrc/`` sources, read once per
    process: a library is named by it and loaded once per process, so an
    edited source takes effect in a new process."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return digest.hexdigest()[:12]


def library_path(spec: Spec) -> Path:
    tags = (f"{k[3:].lower()}{v}" for k, v in spec.flags.items())
    return BUILD_DIR / ("_".join(["libngk", spec.kind, *tags, source_digest()]) + ".so")


def compile_library(spec: Spec) -> tuple[Path, float]:
    """Compile the library for ``spec`` unless it exists; returns its path
    and the seconds spent compiling.  The ptxas report goes to ``<lib>.log``."""
    path = library_path(spec)
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        seconds = _compile(spec, CSRC, tmp, path.with_suffix(".log"))
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path, seconds


def build(specs: list[Spec]) -> list[tuple[Path, float]]:
    """Compile several libraries concurrently (one nvcc process each)."""
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        return list(pool.map(compile_library, specs))


def replace_once(code: str, anchor: str, text: str, name: str) -> str:
    """``code`` with its one ``anchor`` replaced by ``text``; raises when
    source ``name`` no longer holds the anchor exactly once."""
    if code.count(anchor) != 1:
        raise RuntimeError(f"csrc/{name} has changed: {anchor[:60]!r} is not found once")
    return code.replace(anchor, text)


def patched_library(spec: Spec, out_dir: Path, edits: dict) -> ctypes.CDLL:
    """The library for ``spec`` built, with the package's nvcc flags, from a
    copy of ``csrc/`` under ``out_dir`` in which each source named in
    ``edits`` is replaced by ``edits[name](its text)``, and loaded with the
    package's signatures: the profiling tools' variants of the shipped
    kernels.  The library is named by a digest of the flags and the edited
    sources (built once for each); the ptxas report goes to ``<lib>.log``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {name: (CSRC / name).read_text() for name in SOURCES}
    texts.update({name: edit(texts[name]) for name, edit in edits.items()})
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *(f"{k}={v}" for k, v in spec.flags.items())]).encode())
    for name in SOURCES:
        (out_dir / name).write_text(texts[name])
        digest.update(texts[name].encode())
    lib_path = out_dir / f"libngk_{spec.kind}_{digest.hexdigest()[:12]}.so"
    if not lib_path.exists():
        _compile(spec, out_dir, lib_path, lib_path.with_suffix(".log"))
    return _open(lib_path, spec)


def load(spec: Spec, device: torch.device) -> ctypes.CDLL:
    """The loaded library for ``spec``, built first if needed."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA device, got {device}")
    key = (spec.kind, *spec.flags.items())
    lib = _LIBRARIES.get(key)
    if lib is None:
        lib = _LIBRARIES[key] = _open(compile_library(spec)[0], spec)
    return lib


def kernel_device(t: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (run the twin)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def bf16_operands(dtype) -> bool:
    """Whether a kernel's operand-dtype option (``mlp_dtype``,
    ``matmul_dtype``) asks for bf16 products: None or ``torch.float32`` is
    exact f32, ``torch.bfloat16`` rounds the product operands."""
    if dtype is None or dtype == torch.float32:
        return False
    if dtype == torch.bfloat16:
        return True
    raise ValueError(f"operand dtype must be None, torch.float32 or torch.bfloat16, got {dtype!r}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 value (ties to even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def check_f32(t: torch.Tensor, name: str) -> torch.Tensor:
    """A kernel operand: f32, contiguous, on a CUDA device."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t


def day_dims(config: NanogridConfig) -> tuple[int, int, int, int, float]:
    """Runtime step constants: T, k4, k10, k1, dt."""
    dt = config.time_interval
    return config.steps_per_day, int(4 / dt), int(10 / dt), int(1 / dt), dt


def launch(name: str, fn, *args, device: torch.device) -> None:
    """Call the C entry point ``fn`` on the current stream of ``device`` and
    raise if the launch was refused; counts one launch of ``name``."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.device != device:
            raise ValueError(f"{name}: operand on {a.device}, kernel on {device}")
    c_args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with span("launch"):
            err = fn(*c_args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launch_counts[name] += 1
