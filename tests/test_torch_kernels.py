"""Kernel twins K7 and K8 of the PyTorch port (``ops/gen_rollout.py``) and the
Philox generator of the multiday kernels, with the JAX package as the reference.

The twins run on CPU tensors.  K7's twin is held against
``pallas_gen_rbc_day`` in interpret mode on the same numpy uniforms and PV
shifts, at the tolerance tests/test_pallas.py uses.  K8 draws in-kernel
Philox numbers, which have no JAX counterpart: the generator is checked
against the Random123 known-answer vectors and K8's twin against K7's twin
fed the same draws.  The CUDA kernels are held against the twins in
tests/test_torch_cuda.py.
"""

import ctypes
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.ops.pallas_gen_rollout import pallas_gen_rbc_day

from smart_nanogrid_gym_torch.core.generate import generate_schedule
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.core.rollout import fused_day_rollout
from smart_nanogrid_gym_torch.core.transition import reset
from smart_nanogrid_gym_torch.ops import gen_rbc_day, gen_rbc_multiday, launch_counts, reset_launch_counts
from smart_nanogrid_gym_torch.ops.gen_rollout import (
    gen_rbc_day_plain,
    gen_rbc_multiday_plain,
    kernel_traces,
    pv_shift_from_uniform,
)
from smart_nanogrid_gym_torch.ops.philox import day_uniforms, philox4x32_10
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

from torch_parity import kernel_inputs

RBC_CONFIGS = {
    "b-pv-sparse": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "b-pv-reqsoc": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                                  different_battery_capacities=False,
                                  requested_state_of_charge=True),
    "b-pv-fixedcap": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                                    different_battery_capacities=False),
    "basic-ondep": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False,
                                  penalty_mode="on_departure"),
}


@pytest.mark.parametrize("name", list(RBC_CONFIGS))
def test_rbc_day_twin_matches_pallas(name):
    config = RBC_CONFIGS[name]
    u, pv = kernel_inputs(config, 3)
    with jax.enable_x64(False):
        params = jax_make_params(config, dtype=jnp.float32)
        rew_ref, soc_ref = pallas_gen_rbc_day(config, params, jnp.asarray(u), jnp.asarray(pv),
                                              interpret=True)
    rew, soc = gen_rbc_day(config, make_params(config, torch.float32, "cpu"),
                           torch.from_numpy(u), torch.from_numpy(pv))
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_ref), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(soc.numpy(), np.asarray(soc_ref), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(RBC_CONFIGS))
def test_rbc_day_twin_matches_plain_engine(name):
    """K7's twin against the port's own engine (generate_schedule, reset and
    fused_day_rollout with the RBC) on the same uniforms, in f32."""
    config = RBC_CONFIGS[name]
    u, pv = kernel_inputs(config, 7, batch=64)
    params = make_params(config, torch.float32, "cpu")
    schedule = generate_schedule(config, params, torch.from_numpy(u).permute(3, 0, 1, 2))
    state, _ = reset(config, params, schedule, pv_shift=torch.from_numpy(pv))
    final, (_, rewards, _) = fused_day_rollout(config, params, state, make_rbc_policy_fn(config),
                                               next_pv_shift=state.pv_shift)
    rew, soc = gen_rbc_day(config, params, torch.from_numpy(u), torch.from_numpy(pv))
    np.testing.assert_allclose(rew.numpy(), rewards.numpy(), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(soc.numpy(), final.soc[..., config.steps_per_day - 1].T.numpy(),
                               rtol=2e-5, atol=1e-5)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        as_t = lambda v: torch.tensor(v, dtype=torch.int64)
        got = philox4x32_10(tuple(map(as_t, ctr)), tuple(map(as_t, key)))
        assert tuple(int(x) for x in got) == want


def test_day_uniforms_layout():
    u, u_pv = day_uniforms(seed=5, day=2, batch=16, steps=24, num_chargers=6, device="cpu")
    assert u.shape == (24, 5, 6, 16) and u_pv.shape == (16,)
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # charger 5 is word 1 of group 1 at counter (day, t, kind, 1), key (seed, env)
    t, k, env = 7, 3, 11
    as_t = lambda v: torch.tensor(v, dtype=torch.int64)
    words = philox4x32_10((as_t(2), as_t(t), as_t(k), as_t(1)), (as_t(5), as_t(env)))
    assert float(u[t, k, 5, env]) == float((words[1] >> 8).float() * 2.0 ** -24)
    # independent streams: other seed, other day
    assert not torch.equal(u, day_uniforms(6, 2, 16, 24, 6, "cpu")[0])
    assert not torch.equal(u, day_uniforms(5, 3, 16, 24, 6, "cpu")[0])


def test_rbc_multiday_twin_equals_explicit_days():
    """Two Philox days of K8's twin against K7's twin fed the same draws."""
    config = RBC_CONFIGS["b-pv-sparse"]
    traces = kernel_traces(make_params(config, torch.float32, "cpu"), torch.device("cpu"))
    stats = gen_rbc_multiday_plain(config, traces, num_days=2, seed=9, batch=64)
    batt = torch.full((64,), 0.5)
    returns = []
    for day in range(2):
        u, u_pv = day_uniforms(9, day, 64, config.steps_per_day, config.num_chargers, "cpu")
        rew, _ = gen_rbc_day_plain(config, traces, u, pv_shift_from_uniform(u_pv), batt)
        returns.append(rew.sum(0, dtype=torch.float64))
    days = torch.stack(returns)
    np.testing.assert_allclose(stats[0].double().numpy(), days.sum(0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(stats[1].double().numpy(), (days ** 2).sum(0).numpy(), rtol=1e-5)


def test_wrappers_guard_baked_params():
    config = RBC_CONFIGS["b-pv-sparse"]
    params = make_params(config, torch.float32, "cpu")
    bad = params._replace(batt_capacity=torch.tensor(100.0))
    u, pv = kernel_inputs(config, 1, batch=8)
    with pytest.raises(ValueError, match="batt_capacity"):
        gen_rbc_day(config, bad, torch.from_numpy(u), torch.from_numpy(pv))
    with pytest.raises(ValueError, match="batt_init_soc"):
        gen_rbc_multiday(config, params._replace(batt_init_soc=torch.tensor(0.3)), 1, 0, 8)
    with pytest.raises(ValueError, match="non-v2x"):
        gen_rbc_day(NanogridConfig(vehicle_to_everything=True), params,
                    torch.from_numpy(u), torch.from_numpy(pv))


def test_cpu_tensors_take_the_plain_path():
    config = RBC_CONFIGS["b-pv-sparse"]
    reset_launch_counts()
    gen_rbc_multiday(config, make_params(config, torch.float32, "cpu"), 1, 0, 8)
    assert sum(launch_counts.values()) == 0


def test_gae_routes_cpu_tensors_to_the_twin(monkeypatch):
    """``ops/gae.py`` runs CPU tensors through the eager twin: it loads no
    library and launches nothing, and gives the twin's results."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gae import gae, gae_plain

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call loaded or launched a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    g = torch.Generator().manual_seed(5)
    rewards, values = torch.randn((2, 24, 37), generator=g)
    dones, last_value = torch.rand((24, 37), generator=g) < 0.2, torch.randn(37, generator=g)
    reset_launch_counts()
    got = gae(rewards, values, dones, last_value, 0.99, 0.95)
    assert not launch_counts
    for g_, w in zip(got, gae_plain(rewards, values, dones, last_value, 0.99, 0.95)):
        assert torch.equal(g_, w)


def test_library_path_reads_the_sources_once_per_process(monkeypatch):
    """Every launch names its library through ``library_path``: the digest of
    the sources is read on a process's first call and never again."""
    from pathlib import Path

    from smart_nanogrid_gym_torch.ops import _build

    _build.source_digest.cache_clear()
    reads = []
    read_bytes = Path.read_bytes
    monkeypatch.setattr(Path, "read_bytes", lambda self: reads.append(self.name) or read_bytes(self))
    spec = _build.config_spec(RBC_CONFIGS["b-pv-sparse"])
    first = _build.library_path(spec)
    assert sorted(reads) == sorted(_build.SOURCES)
    reads.clear()
    assert _build.library_path(spec) == first
    assert _build.library_path(_build.config_spec(RBC_CONFIGS["basic-ondep"])) != first
    assert reads == []


def _library_specs():
    """One spec of each kind of ``_build.KINDS`` (the day kind with each actor)."""
    from smart_nanogrid_gym_torch.core.config import NanogridConfig as PortConfig
    from smart_nanogrid_gym_torch.ops import _build

    config = PortConfig(num_chargers=8)
    return {"kernels-ppo": _build.config_spec(config), "kernels-ddpg": _build.config_spec(config, (400, 300), "ddpg"),
            "sweep": _build.sweep_spec(25, 9, 64, 64), "ddpg_sweep": _build.ddpg_sweep_spec(25, 9, 400, 300),
            "engine": _build.engine_spec(config), "gae": _build.gae_spec()}


def _c_type(decl: str) -> str:
    """A C parameter's type class: ``pointer`` or its scalar type."""
    return "pointer" if "*" in decl else decl.replace("const ", "").rsplit(None, 1)[0]


def _ctypes_type(t) -> str:
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_uint: "unsigned int", ctypes.c_float: "float",
            ctypes.c_double: "double", ctypes.c_longlong: "long long"}[t]


@pytest.mark.parametrize("name", list(_library_specs()))
def test_build_table_matches_the_extern_c_entry_points(name):
    """Every C name ``_build`` binds for a library is defined, returning
    ``int``, inside an ``extern "C"`` block of its kind's entry sources, with
    the parameters of its ctypes signature in number and type class; every
    ``-D`` value the library is built with is read by those sources."""
    from smart_nanogrid_gym_torch.ops import _build

    specs = _library_specs()
    assert {spec.kind for spec in specs.values()} == set(_build.KINDS)
    spec = specs[name]
    kind = _build.KINDS[spec.kind]
    texts = [(_build.CSRC / source).read_text() for source in kind.sources]
    defined = {}
    for text in texts:
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text, re.S):
            for fn, params in re.findall(r"^int (ngk_\w+)\(([^)]*)\)\s*\{", block, re.M):
                defined[fn] = [_c_type(p) for p in (x.strip() for x in params.split(",")) if p]
    bound = {**kind.signatures, **(kind.by_actor[spec.flags["NG_ACTOR"]] if kind.by_actor else {})}
    for fn, argtypes in bound.items():
        assert fn in defined, f"{fn} is not defined in the extern \"C\" blocks of {kind.sources}"
        assert [_ctypes_type(t) for t in argtypes] == defined[fn], fn
    for flag in spec.flags:
        assert any(re.search(rf"\b{flag}\b", text) for text in texts), f"no source of {kind.sources} reads {flag}"


def test_baked_constants_equal_the_kernels_constexpr_block():
    """``csrc/day_step.cuh``'s reference constants are ``param_guard``'s,
    each the f32 of the value (or product) the twins compute with."""
    from smart_nanogrid_gym_torch.ops import _build, param_guard as g

    want = {"kMaxPEff": g.MAX_P * g.EFF, "kBattMaxPEff": g.B_MAXP * g.B_EFF, "kBattCap": g.B_CAP,
            "kBattDod": g.BATT_DOD, "kBattInit": g.BATT_INIT_SOC, "kMargin": g.MARGIN, "kGain": g.GAIN,
            "kWBatt": g.W_BATT, "kWVeh": g.W_VEH, "kGridW": g.GRID_W, "kSell": g.SELL,
            "kArrival": g.ARRIVAL_THRESHOLD, "kSocLow": g.SOC_LOW, "kSocSpan": g.SOC_SPAN, "kCapLow": g.CAP_LOW,
            "kCapSpan": g.CAP_SPAN, "kDefaultCap": g.DEFAULT_CAP, "kSoon": 24.0 * g.DEPARTURE_SOON_THRESHOLD}
    code = (_build.CSRC / "day_step.cuh").read_text()
    block = code[code.index("// reference constants"):code.index("// Static configuration")]
    got = {}
    for name, expr in re.findall(r"constexpr float (k\w+) = (.+?);", block):
        product = re.fullmatch(r"static_cast<float>\(([\d.]+) \* ([\d.]+)\)", expr)
        literal = re.fullmatch(r"([\d.]+)f", expr)
        assert product or literal, f"{name} = {expr}: not a literal or a product of two"
        got[name] = np.float32(float(product[1]) * float(product[2]) if product else float(literal[1]))
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name] == np.float32(value), name



def test_every_use_of_build_names_what_it_has():
    """Every ``_build.<name>`` read, and every ``_build`` attribute patched by
    name (``mock.patch.object(_build, "<name>", ...)``,
    ``monkeypatch.setattr(_build, "<name>", ...)``), in the port, its tools,
    the tests, ``nanobench`` and ``chip_smoke.py`` names an attribute that
    ``ops/_build.py`` has: the profiling tools and the card tests run only on
    a card, so a stale name would show only there."""
    import ast
    from pathlib import Path

    from smart_nanogrid_gym_torch.ops import _build

    repo = Path(__file__).resolve().parents[1]
    paths = [repo / "chip_smoke.py", *sorted((repo / "smart_nanogrid_gym_torch").rglob("*.py")),
             *sorted((repo / "nanobench").rglob("*.py")), *sorted((repo / "tests").glob("*.py"))]
    uses = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "_build":
                uses.append((path, node.lineno, node.attr))
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("object", "setattr") and len(node.args) >= 2
                  and isinstance(node.args[0], ast.Name) and node.args[0].id == "_build"
                  and isinstance(node.args[1], ast.Constant)):
                uses.append((path, node.lineno, node.args[1].value))
    assert len({path for path, _, _ in uses}) > 20
    stale = [f"{path.relative_to(repo)}:{line}: _build.{name}" for path, line, name in uses
             if not hasattr(_build, name)]
    assert not stale, "names _build does not have:\n" + "\n".join(stale)
