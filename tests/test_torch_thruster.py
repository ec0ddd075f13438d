"""Port against the JAX package: the reference-format thruster wrapper
(``hallthruster_jl`` / ``run_simulation``), its input-tree mapping, the
cycle-averaged current and the pem_v0 component configuration.

Inputs are made with numpy from fixed seeds and handed to both packages (numpy
to JAX, tensors to the port). Tolerances: trees, solver configs, parameters and
failure masks equal exactly (both compute them from the same float32 inputs in
the same order); the cycle-averaged current within rtol 1e-6 (float32 sums taken
in another order); the end-to-end run's QoIs within 1%, the run-level bound of
tests/test_pallas.py."""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp
import hallthrusterpem_tpu.models.thruster as jthr
from hallthrusterpem_tpu.models.thruster import mapping as jmap
from hallthrusterpem_tpu.models.thruster import pallas_step as ps
from hallthrusterpem_tpu.models.thruster.postprocess import cycle_averaged_current as jax_cycle
import hallthrusterpem_tpu_torch.models.thruster as tthr
from hallthrusterpem_tpu_torch.models.thruster import mapping as tmap
from hallthrusterpem_tpu_torch.models.thruster.postprocess import cycle_averaged_current

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CONFIG_JSON = ROOT / "hallthrusterpem_tpu_torch" / "configs" / "pem_v0_SPT-100.json"


def _component():
    """The pem_v0 Thruster component's settings, from the packaged JSON copy of
    the pem_v0 SPT-100 configuration."""
    doc = json.loads(CONFIG_JSON.read_text())
    comp = next(c for c in doc["components"] if c["name"] == "Thruster")
    return dict({k: comp[k] for k in ("thruster", "config", "simulation", "postprocess")},
                model_fidelity=list(ast.literal_eval(comp["model_fidelity"])))


def _inputs(B, seed=0):
    """PEM thruster inputs within 8% of the pem_v0 nominals (numpy float32)."""
    rng = np.random.default_rng(seed)
    nom = {"P_b": 1e-5, "V_a": 300.0, "mdot_a": 5e-6, "T_e": 1.32721, "u_n": 145.40052,
           "l_t": 1.87915e-3, "a_1": 0.00561226, "a_2": 41.1918, "dz": 0.2, "z0": -0.03104,
           "p0": 56.86006e-6, "V_cc": 30.0}
    return {k: (v * (1 + 0.08 * rng.uniform(-1, 1, B))).astype(np.float32) for k, v in nom.items()}


def _torch(x):
    return {k: torch.as_tensor(v) for k, v in x.items()}


def _assert_same(got, ref, path="tree"):
    """Trees equal: same keys and list lengths, arrays equal exactly; a device's
    field file may lie in either package (compared by name)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            if k == "file":
                assert Path(got[k]).name == Path(ref[k]).name, path
            else:
                _assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, jnp.ndarray, torch.Tensor)) or isinstance(got, torch.Tensor):
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(g, np.asarray(ref), err_msg=path)
    else:
        assert got == ref, (path, got, ref)


@pytest.mark.parametrize("variant", ["pem_v0", "no_fidelity", "gaussian", "custom_fidelity"])
def test_format_input_tree_matches(variant):
    comp = _component()
    x = _inputs(6)
    kw = dict(thruster="SPT-100", config=comp["config"], simulation=comp["simulation"],
              postprocess=comp["postprocess"], model_fidelity=(2, 2))
    if variant == "no_fidelity":
        kw["model_fidelity"] = None
    elif variant == "gaussian":
        kw["config"] = dict(comp["config"], anom_model={"type": "GaussianBohm", "hall_min": 0.01,
                                                        "hall_max": 0.1})
        x = {k: v for k, v in x.items() if k not in ("a_1", "a_2", "dz", "z0", "p0")}
        x["anom_max"] = np.float32(8.0)
    elif variant == "custom_fidelity":
        kw["fidelity_function"] = lambda fid, tree: {"num_cells": 60, "dt": 8e-9}
    ref = jmap.format_input_tree(x, jmap.PEM_TO_JULIA, **kw)
    got = tmap.format_input_tree(_torch(x), tmap.PEM_TO_JULIA, **kw)
    _assert_same(got, ref)


def test_path_map_and_conversions_match():
    assert tmap.PEM_TO_JULIA == jmap.PEM_TO_JULIA
    x = _inputs(4, seed=1)
    x["u_ion"] = np.arange(8, dtype=np.float32).reshape(4, 2)  # a list-indexed path
    tree_j, tree_t = {"config": {"anom_model": {"dz": 0.5}}}, {"config": {"anom_model": {"dz": 0.5}}}
    jmap.convert_to_config(x, tree_j, jmap.PEM_TO_JULIA)
    tmap.convert_to_config(_torch(x), tree_t, tmap.PEM_TO_JULIA)
    _assert_same(tree_t, tree_j)
    _assert_same(tmap.convert_to_pem(tree_t, tmap.PEM_TO_JULIA),
                 jmap.convert_to_pem(tree_j, jmap.PEM_TO_JULIA))
    with pytest.raises(KeyError):
        tmap.convert_to_config({"no_such_variable": 1.0}, {}, tmap.PEM_TO_JULIA)


@pytest.mark.parametrize("adaptive", ["off", "cfl", "clamped"])
def test_tree_to_solver_inputs_matches(adaptive, monkeypatch):
    """The static config (including the adaptive CFL dt and its clamp to
    [min_dt, max_dt]), the per-sample parameters and the B-field."""
    monkeypatch.delenv("HTPEM_TRACES", raising=False)
    comp = _component()
    config = dict(comp["config"], anode_alpha=0.05, wall_loss_model={"loss_scale": 0.9},
                  neutral_groups=2)
    sim = dict(comp["simulation"], adaptive=adaptive != "off")
    if adaptive == "clamped":
        sim["max_dt"] = 2e-9
    x = _inputs(5, seed=2)
    kw = dict(config=config, simulation=sim, postprocess=comp["postprocess"], model_fidelity=None)
    tree_j = jmap.format_input_tree(x, jmap.PEM_TO_JULIA, **kw)
    tree_t = tmap.format_input_tree(_torch(x), tmap.PEM_TO_JULIA, **kw)
    cj, pj, bj = jthr._tree_to_solver_inputs(tree_j)
    ct, pt, bt = tthr._tree_to_solver_inputs(tree_t, device="cpu")
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.num_save, ct.neutral_groups, ct.anode_alpha, ct.num_cells) == (1000, 2, 0.05, 100)
    expected_dt = {"off": sim["dt"], "clamped": 2e-9}
    if adaptive in expected_dt:
        assert ct.dt == expected_dt[adaptive]
    else:
        assert 2e-9 < ct.dt < sim["max_dt"]
    assert set(pt) == set(pj)
    for k in pj:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]), err_msg=k)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj, np.float32))


def test_solver_backend_policy(monkeypatch):
    """CPU tensors run the plain K-step version and launch no kernel; grids wider
    than the kernel layout run the lax solver."""
    from hallthrusterpem_tpu_torch.models.thruster import _kernels

    cfg = tthr.SolverConfig(num_cells=60, dt=1e-8, duration=2e-8, average_start_time=0.0)
    params = tthr.make_params({k: torch.as_tensor(v) for k, v in _inputs(2).items()
                               if k in ("V_cc", "mdot_a")}, device="cpu")
    base_B = torch.full((cfg.nc,), 0.01)
    blocks = []
    monkeypatch.setattr(tthr.fs, "kstep_plain",
                        lambda *a, _f=tthr.fs.kstep_plain: blocks.append(1) or _f(*a))
    _kernels.reset_counts()
    out = tthr.dispatch_solver(params, base_B, cfg)
    assert blocks and _kernels.launch_counts == {"kstep": 0, "step": 0}
    assert out["thrust"].shape == (2,) and out["thrust"].device.type == "cpu"
    wide = tthr.SolverConfig(num_cells=300, dt=1e-8, duration=2e-8, average_start_time=0.0)
    n_blocks = len(blocks)
    out = tthr.dispatch_solver(params, torch.full((wide.nc,), 0.01), wide)
    assert len(blocks) == n_blocks and _kernels.launch_counts == {"kstep": 0, "step": 0}
    assert out["thrust"].shape == (2,) and out["ui"].shape == (2, 1, wide.nc)


def test_kernel_constants_cache_is_bounded():
    """Adaptive dt makes a new config for nearly every batch: the rate
    coefficients are kept once per (propellant, charge states, device) and the
    config structs in a small LRU."""
    from hallthrusterpem_tpu_torch.models.thruster import _kernels

    comp = _component()
    kw = dict(config=comp["config"], simulation=dict(comp["simulation"], adaptive=True),
              postprocess=comp["postprocess"], model_fidelity=None)
    _kernels._coef_cache.clear()
    _kernels._cached_params.cache_clear()
    dts = set()
    for seed in range(12):
        tree = tmap.format_input_tree(_torch(_inputs(3, seed=seed)), tmap.PEM_TO_JULIA, **kw)
        cfg = tthr._tree_to_solver_inputs(tree, device="cpu")[0]
        dts.add(cfg.dt)
        params, coef = _kernels._constants(cfg, torch.device("cpu"))
        assert params.dt == pytest.approx(cfg.dt, rel=1e-6)
        np.testing.assert_array_equal(coef.numpy(), _kernels.rate_coefficients(cfg))
    assert len(dts) > 8
    assert len(_kernels._coef_cache) == 1
    assert _kernels._cached_params.cache_info().currsize <= 8


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tthr.hallthruster_jl(_torch(_inputs(2)))
    with pytest.raises(RuntimeError):
        tthr.run_simulation({"config": {}, "simulation": {}, "postprocess": {}})


def _traces(seed=3):
    """(6, 400) traces: 0, 1 and many upward mean crossings, a NaN row, and two
    noisy breathing rows."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2e-4, 400)
    rows = [
        4.0 + t * 1e3,                                          # monotone: no crossing
        np.where(t < 1.5e-4, 3.0, 5.0),                          # one step up: one crossing
        4.0 + np.sin(2 * np.pi * 2e4 * t),                       # ~4 breathing cycles in the window
        np.full_like(t, np.nan),                                 # failed sample
        4.0 + 0.5 * np.sin(2 * np.pi * 3e4 * t) + 0.1 * rng.standard_normal(t.size),
        5.0 + 0.3 * np.sin(2 * np.pi * 1.7e4 * t + 1.0),
    ]
    return np.asarray(rows, np.float32), t.astype(np.float32)


@pytest.mark.parametrize("t_start", [0.0, 1e-4])
def test_cycle_averaged_current_matches(t_start):
    x, t = _traces()
    ref = np.asarray(jax_cycle(x, t, t_start))
    got = cycle_averaged_current(torch.as_tensor(x), torch.as_tensor(t), t_start).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # per-sample times give the same result as one shared time axis
    tb = np.broadcast_to(t, x.shape)
    np.testing.assert_array_equal(
        cycle_averaged_current(torch.as_tensor(x), torch.as_tensor(tb.copy()), t_start).numpy(), got)


def _raw_solver_output(B, nc, Z, poison=True):
    """A solver result whose rows trip each failure guard of ``hallthruster_jl``
    (I_eq = e mdot / m_i ~ 3.67 A at 5e-6 kg/s; 1.5 Z I_eq ~ 16.5 A at Z = 3):
    0 healthy, 1 T < 0, 2 I_B0 < 0, 3 I_d < 0, 4 eta_m < 0, 5 I_B0 above the cap,
    6 I_d < 0.2 I_eq, 7 I_d > 8 I_eq, 8 ion-velocity peak upstream (shock),
    9 non-finite thrust. With ``poison=False`` every row is healthy."""
    rng = np.random.default_rng(4)
    f = lambda lo, hi: rng.uniform(lo, hi, B).astype(np.float32)
    raw = {"thrust": f(0.05, 0.09), "discharge_current": f(4.0, 6.0), "ion_current": f(3.0, 4.0),
           "mass_eff": f(0.8, 0.95)}
    if poison:
        raw["thrust"][1] = -0.01
        raw["ion_current"][2] = -1.0
        raw["discharge_current"][3] = -2.0
        raw["mass_eff"][4] = -0.1
        raw["ion_current"][5] = 20.0
        raw["discharge_current"][6] = 0.5
        raw["discharge_current"][7] = 40.0
        raw["thrust"][9] = np.nan
    for k in ("discharge_current_std", "current_eff", "voltage_eff", "anode_eff"):
        raw[k] = f(0.1, 0.9)
    z = np.linspace(0, 0.08, nc, dtype=np.float32)
    ui = np.broadcast_to(np.tanh((z - 0.02) / 0.01) * 1.5e4, (B, Z, nc)).copy()
    if poison:
        ui[8, 0, 3] = 5e4  # the peak of charge state 1 sits near the anode
    raw.update(ui=ui.astype(np.float32), z=np.broadcast_to(z, (B, nc)).copy())
    for k in ("nu_anom", "B", "Tev", "ne", "nn", "potential", "E"):
        raw[k] = rng.uniform(1, 2, (B, nc)).astype(np.float32)
    return raw


@pytest.mark.parametrize("avg_start,shock,poison", [
    pytest.param(5e-4, 0.01, True, id="0.0005-0.01"),
    pytest.param(1e-4, None, True, id="0.0001-None"),
    pytest.param(5e-4, 0.01, False, id="0.0005-0.01-all_good"),
])
def test_failure_masks_match(avg_start, shock, poison, monkeypatch):
    """Both wrappers get the same raw solver output (each ``dispatch_solver``
    replaced) and must NaN the same rows of every output, with the same dtypes:
    float64 everywhere once any row is masked, the solver's float32 when none is.
    The I_d window guard applies only when the averaging window starts at or
    after 0.2 ms."""
    monkeypatch.delenv("HTPEM_TRACES", raising=False)
    B = 10
    comp = _component()
    sim = dict(comp["simulation"], adaptive=False, num_save=0)
    post = dict(comp["postprocess"], average_start_time=avg_start)
    x = _inputs(B, seed=5)
    x["mdot_a"] = np.full(B, 5e-6, np.float32)
    raw = _raw_solver_output(B, 202, 3, poison)
    monkeypatch.setattr(jthr, "dispatch_solver", lambda p, b, c: {k: jnp.asarray(v) for k, v in raw.items()})
    monkeypatch.setattr(tthr, "dispatch_solver",
                        lambda p, b, c: {k: torch.as_tensor(v) for k, v in raw.items()})
    kw = dict(config=comp["config"], simulation=sim, postprocess=post, shock_threshold=shock)
    ref = jthr.hallthruster_jl(x, **kw)
    got = tthr.hallthruster_jl(_torch(x), device="cpu", **kw)
    assert set(got) == set(ref)
    bad = np.isnan(ref["T"])
    expected = {0: False, 1: True, 2: True, 3: True, 4: True, 5: True, 6: avg_start >= 2e-4,
                7: avg_start >= 2e-4, 8: shock is not None, 9: True}
    assert bad.tolist() == [poison and expected[i] for i in range(B)]
    for k, v in ref.items():
        if k == "thruster_output":
            continue
        g = got[k].numpy()
        assert g.shape == np.shape(v), k
        assert g.dtype == np.asarray(v).dtype, (k, g.dtype, np.asarray(v).dtype)
        if k != "model_cost":
            assert g.dtype == (np.float64 if poison else np.float32), k
        if k == "model_cost":
            assert np.all(g > 0)
            continue
        np.testing.assert_array_equal(np.isnan(g), np.isnan(np.asarray(v)), err_msg=k)
        np.testing.assert_array_equal(g[~np.isnan(g)], np.asarray(v, np.float32)[~np.isnan(g)], err_msg=k)


def test_run_simulation_end_to_end_matches(tmp_path, monkeypatch):
    """A 60-cell tree of the pem_v0 component (adaptive dt, I_d(t) trace, cycle
    average, output file) through both wrappers; the JAX side runs its Pallas
    K-step driver in interpret mode."""
    monkeypatch.setenv("HTPEM_SOLVER", "pallas")
    monkeypatch.delenv("HTPEM_TRACES", raising=False)
    monkeypatch.delenv("HTPEM_INNER_STEPS", raising=False)
    multi = ps.simulate_batch_pallas_multi
    monkeypatch.setattr(ps, "simulate_batch_pallas_multi",
                        lambda p, b, c: multi(p, b, c, calls_per_dispatch=4, interpret=True))
    comp = _component()
    sim = dict(comp["simulation"], duration=6e-6, num_save=40, grid={"type": "EvenGrid", "num_cells": 60})
    post = dict(comp["postprocess"], average_start_time=3e-6)
    x = _inputs(5, seed=6)
    kw = dict(config=comp["config"], simulation=sim, postprocess=post, model_fidelity=None)
    tree_j = jmap.format_input_tree(x, jmap.PEM_TO_JULIA, **kw)
    tree_t = tmap.format_input_tree(_torch(x), tmap.PEM_TO_JULIA, **kw)
    tree_j["postprocess"]["output_file"] = str(tmp_path / "jax.json")
    tree_t["postprocess"]["output_file"] = str(tmp_path / "torch.json")
    ref = jthr.run_simulation(tree_j)["output"]["average"]
    got = tthr.run_simulation(tree_t, device="cpu")["output"]["average"]
    assert set(got) == set(ref)
    assert got["discharge_current_trace"].shape == (5, 40)
    assert torch.isfinite(got["discharge_current_trace"]).all()
    for key in ("thrust", "discharge_current", "ion_current"):
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert np.max(np.abs(g - r) / np.abs(r)) < 0.01, key
    np.testing.assert_allclose(got["discharge_current_trace"].numpy(), ref["discharge_current_trace"],
                               rtol=0.01)
    np.testing.assert_array_equal(got["trace_times"].numpy(), ref["trace_times"])
    assert len(got["ui"]) == len(ref["ui"]) == 1
    written_j = json.loads((tmp_path / "jax.json").read_text())
    written_t = json.loads((tmp_path / "torch.json").read_text())
    assert set(written_t) == set(written_j)
    assert set(written_t["output"]["average"]) == set(written_j["output"]["average"])


def test_hallthruster_jl_end_to_end_matches_jax():
    """Both packages' wrappers, end to end with no stand-in: the pem_v0 SPT-100
    component at its fidelity (2,2) over 2e-6 s (adaptive dt, ~900 steps), B = 3.
    JAX takes its lax solver on the CPU, the port its K-step plain version. The
    same rows are masked, the outputs have the same dtypes, and the unguarded
    time averages agree within 1%, the run-level bound."""
    comp = _component()
    duration = 2e-6
    sim = dict(comp["simulation"], duration=duration, num_save=0)
    post = dict(comp["postprocess"], average_start_time=0.5 * duration)
    x = _inputs(3, seed=0)
    kw = dict(config=comp["config"], simulation=sim, postprocess=post,
              model_fidelity=tuple(comp["model_fidelity"]))
    assert jthr.solver_backend(jthr._tree_to_solver_inputs(
        jmap.format_input_tree(x, jmap.PEM_TO_JULIA, **kw))[0])[0] == "lax"
    ref = jthr.hallthruster_jl(x, **kw)
    got = tthr.hallthruster_jl(_torch(x), device="cpu", **kw)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(np.isnan(got["T"].numpy()), np.isnan(ref["T"]))
    for k in ("T", "I_d", "I_B0", "u_ion"):
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype, k
    avg_ref, avg_got = ref["thruster_output"]["output"]["average"], got["thruster_output"]["output"]["average"]
    for key in ("thrust", "discharge_current", "ion_current"):
        g, r = avg_got[key].numpy(), np.asarray(avg_ref[key])
        assert np.all(np.isfinite(r)), key
        assert np.max(np.abs(g - r) / np.abs(r)) < 0.01, key


def test_component_config_json_matches_yaml():
    """The pem_v0 Thruster component of the packaged JSON copy equals its YAML."""

    class Loader(yaml.SafeLoader):
        pass

    def untagged(loader, suffix, node):
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node, deep=True)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node, deep=True)
        return loader.construct_scalar(node)

    Loader.add_multi_constructor("", untagged)
    doc = yaml.load((ROOT / "scripts" / "pem_v0" / "pem_v0_SPT-100.yml").read_text(), Loader=Loader)
    yml = next(c for c in doc["components"] if c["name"] == "Thruster")
    comp = _component()
    assert set(comp) == {"thruster", "model_fidelity", "config", "simulation", "postprocess"}
    assert comp["thruster"] == yml["thruster"]
    assert tuple(comp["model_fidelity"]) == ast.literal_eval(yml["model_fidelity"])
    for k in ("config", "simulation", "postprocess"):
        assert comp[k] == yml[k], k
