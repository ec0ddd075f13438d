"""Port against the JAX package: the SPT-100 physics studies of
``hallthrusterpem_tpu_torch/scripts`` (``anchors``, ``probe_uion``,
``diagnose_current``, ``probe_anom_shape``, ``probe_anode_zone``, ``tune_r5``,
``diagnose_breathing``, ``kernel_bench``) and the System/Variable accessors, on
the CPU.

Each script is held against its counterpart in ``scripts/``, loaded by file
path. The scoring halves get the same model outputs (numpy, from a seed) in
both packages and must give the same tables within 1e-12 (float64 numpy; the
artifacts round as JAX's do), and the same solver inputs (trees, configs and
parameters); ``diagnose_current``, which only prints, must print the same
lines. The solving halves run at 60 cells (the fidelity-driven
``diagnose_current`` at its smallest, 100) for about 1,100 steps in both
packages (JAX on its lax solver, the port on the K-step plain version): equal
finite masks, thrust, discharge and beam current within 1% (the bound of
``tests/test_pallas.py::test_multistep_kernel_matches_lax``).
``diagnose_breathing``'s two routes (snapshots between K-step launches, lax
steps) agree with each other and with JAX's lax snapshots within 1e-4 scaled
after 100 steps.
"""

import dataclasses
import importlib.util
import json
import logging
import runpy
import sys

import numpy as np
import pytest
import torch

import hallthrusterpem_tpu
import hallthrusterpem_tpu.models.thruster as jthruster
import hallthrusterpem_tpu_torch
import hallthrusterpem_tpu_torch.models.thruster as tthruster
from hallthrusterpem_tpu.core import yaml_loader as jyaml
from hallthrusterpem_tpu_torch.core.json_loader import load_system
from hallthrusterpem_tpu_torch.scripts import (_spt100, anchors, diagnose_breathing, diagnose_current,
                                               kernel_bench, probe_anode_zone, probe_anom_shape, probe_uion,
                                               tune_r5)
from test_torch_system import CONFIGS, ROOT, yaml_as_json_doc

torch.set_num_threads(2)
SCORE_TOL = 1e-12
QOI_TOL = 1e-2
SNAP_TOL = 1e-4
#: the short solves: 60 cells, ~1,100 steps at the adaptive dt of 3 charge states
SHORT_CELLS = 60
SHORT_DURATION = 8e-6


def _jax_script(name: str):
    """A script of ``scripts/`` as a module of its own name (``jax_<name>``)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b, path="") -> None:
    """Nested JSON-like values equal: floats within SCORE_TOL relative, NaN where NaN."""
    a, b = (x.tolist() if isinstance(x, np.ndarray) else x for x in (a, b))
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        a, b = float(a), float(b)
        assert (np.isnan(a) and np.isnan(b)) or a == b or abs(a - b) <= SCORE_TOL * max(abs(a), abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _same_arrays(a, b, path="") -> None:
    """Nested trees of arrays and scalars equal (trees of the two packages'
    solver inputs; the device dict is compared by its keys)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            if k == "thruster":
                assert set(a[k]) == set(b[k]), path
            else:
                _same_arrays(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (str, bool)) or isinstance(b, (str, bool)):
        assert a == b, (path, a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64), path)


def _same_config(got, ref) -> None:
    """Two packages' ``SolverConfig``s equal field by field (the geometry by its fields)."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


def _rng_outputs(n: int, nc: int, seed: int, ncharge: int = 3) -> dict:
    """Averaged solver outputs of ``n`` rows in the wrapper's layout (numpy,
    float32), near the SPT-100 design point, one row's thrust NaN."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    z = np.broadcast_to(np.concatenate([[0.0], (np.arange(nc - 2) + 0.5) * 0.08 / (nc - 2), [0.08]]), (n, nc))
    u = 1.8e4 / (1 + np.exp(-(z - 0.026) / 0.004)) - 500 + rng.normal(0, 300, (n, nc))
    thrust = 0.0817 * (1 + rng.uniform(-0.1, 0.1, n))
    thrust[min(2, n - 1)] = np.nan
    return {
        "thrust": f32(thrust), "discharge_current": f32(4.6 * (1 + rng.uniform(-0.1, 0.1, n))),
        "discharge_current_std": f32(rng.uniform(0.1, 1.0, n)),
        "ion_current": f32(3.6 * (1 + rng.uniform(-0.15, 0.15, n))),
        "current_eff": f32(rng.uniform(0.7, 0.9, n)), "mass_eff": f32(rng.uniform(0.8, 1.0, n)),
        "anode_eff": f32(rng.uniform(0.4, 0.6, n)),
        "z": f32(z), "ui": [f32(u * (0.9 + 0.1 * k)) for k in range(ncharge)],
        "ne": f32(1e17 * (1 + 10 * np.exp(-((z - 0.024) / 0.01) ** 2)) * rng.uniform(0.9, 1.1, (n, nc))),
        "Tev": f32(3 + 20 * np.exp(-((z - 0.023) / 0.008) ** 2) * rng.uniform(0.9, 1.1, (n, nc))),
        "nn": f32(1e19 * np.exp(-z / 0.02) + 1e16),
        "B": f32(0.02 * np.exp(-0.5 * ((z - 0.025) / 0.011) ** 2) + 1e-4),
        "nu_anom": f32(1e6 * rng.uniform(1, 10, (n, nc))),
        "E": f32(5e4 * np.exp(-((z - 0.026) / 0.006) ** 2) * rng.uniform(0.9, 1.1, (n, nc))),
        "potential": f32(300 - 270 / (1 + np.exp(-(z - 0.027) / 0.004))),
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.as_tensor(np.asarray(tree))


class _StubSystem:
    """A System whose ``predict`` returns fixed outputs and records its batch."""

    def __init__(self, inputs, out):
        self._inputs, self.out, self.batch = inputs, out, None
        self.device = torch.device("cpu")

    def inputs(self):
        return self._inputs

    def set_logger(self, **_kw):
        pass

    def predict(self, batch, use_model=None):
        assert use_model == "best"
        self.batch = {k: np.asarray(v) for k, v in batch.items()}
        return self.out


def _system_outputs(n: int, seed: int) -> dict:
    """The System outputs the anchors read: scalars, u_ion(z), j_ion(theta)."""
    rng = np.random.default_rng(seed)
    avg = _rng_outputs(n, 202, seed)
    theta = np.broadcast_to(np.deg2rad(np.arange(91.0)), (n, 91))
    data = _spt100.SCALAR_ANCHORS[0]["data"]
    out = {q: np.asarray(data[q] * (1 + rng.uniform(-0.12, 0.12, n)), np.float32) for q in data}
    out["T"][min(3, n - 1)] = np.nan
    out.update(u_ion_coords=avg["z"], u_ion=avg["ui"][0], j_ion_coords=np.asarray(theta, np.float32),
               j_ion=np.asarray(8.0 * np.exp(-theta**2 / 0.3) * rng.uniform(0.8, 1.2, (n, 91)), np.float32))
    return out


# ---------------------------------------------------------------- tables and accessors

@pytest.mark.parametrize("name,constants", [
    ("anchors", ("SCALAR_ANCHORS", "UION_TOL", "JION_TOL")),
    ("probe_anom_shape", ("NOM", "W0", "CASES")),
    ("probe_anode_zone", ("NOM", "CASES")),
    ("tune_r5", ("FIXED", "ANCHOR", "PBS", "VCC", "BOX", "BOX_REFINE")),
])
def test_constants_match_jax(name, constants):
    """The anchor table and tolerances, and each study's design, equal JAX's."""
    jax_mod = _jax_script(name)
    port_mod = _spt100 if name == "anchors" else globals()[name]
    for c in constants:
        assert getattr(port_mod, c) == getattr(jax_mod, c), (name, c)
    if name == "anchors":
        assert anchors.SCALAR_ANCHORS is _spt100.SCALAR_ANCHORS
    if name == "probe_anode_zone":
        assert (probe_anode_zone.PBS, probe_anode_zone.VCC) == (tune_r5.PBS, tune_r5.VCC)


@pytest.mark.parametrize("config", ["fake_pem", "pem_v0_SPT-100"])
def test_accessors_match_jax(config, tmp_path):
    """``System.variables``, ``exo_vars``, ``x_vars``, ``refine_level``,
    ``build_metrics``, ``Component.max_refine``, ``truth_alpha``, ``_model``,
    ``Variable.bounds()``, ``mu``, ``param_type``, ``to_tex`` and the
    distributions' ``bounds(nominal)`` equal JAX's on the YAML and its JSON copy."""
    yml = ROOT / "tests" / "fake_pem.yml" if config == "fake_pem" else CONFIGS["pem_v0_SPT-100.json"]
    path = tmp_path / f"{config}.json"
    path.write_text(json.dumps(yaml_as_json_doc(yml)))
    jsys, tsys = jyaml.load_system(yml), load_system(path, device="cpu")
    names = lambda vs: [v.name for v in vs]
    assert sorted(tsys.variables) == sorted(jsys.variables)
    assert names(tsys.exo_vars) == names(jsys.exo_vars) == names(tsys.x_vars) == names(jsys.x_vars)
    assert tsys.refine_level == jsys.refine_level == 0
    assert tsys.build_metrics == jsys.build_metrics == {"train_record": [], "test_stats": []}
    tsys.train_history.append({"test_error": {"T": 0.5}})
    jsys.train_history.append({"test_error": {"T": 0.5}})
    assert tsys.refine_level == jsys.refine_level == 1 and tsys.build_metrics == jsys.build_metrics
    for tc, jc in zip(tsys.components, jsys.components):
        assert (tc.max_refine, tc.truth_alpha) == (jc.max_refine, jc.truth_alpha) == (jc.model_fidelity,) * 2
    for name, jv in jsys.variables.items():
        tv = tsys.variables[name]
        assert tv.bounds() == jv.bounds(), name
        assert tv.param_type == jv.param_type, name
        for kw in ({}, {"units": True}, {"symbol": False}):
            assert tv.to_tex(**kw) == jv.to_tex(**kw), (name, kw)
        try:
            mu = jv.mu
        except AttributeError:
            with pytest.raises(AttributeError):
                tv.mu
        else:
            assert tv.mu == mu, name
        if jv.distribution is not None:
            assert tv.distribution.bounds(jv.nominal) == jv.distribution.bounds(jv.nominal), name
    if config == "fake_pem":
        x = {v.name: np.full(3, v.nominal, np.float64) for v in jsys["Thruster"].inputs}
        ref = jsys["Thruster"]._model(x, ())
        got = tsys["Thruster"]._model({k: torch.as_tensor(v) for k, v in x.items()}, ())
        for k in ("T", "I_B0"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6)


def test_get_logger_matches_jax():
    ref, got = hallthrusterpem_tpu.get_logger("jax_side_logger"), hallthrusterpem_tpu_torch.get_logger("port_logger")
    assert got.level == ref.level == logging.WARNING and len(got.handlers) == len(ref.handlers) == 1
    assert got.handlers[0].formatter._fmt == ref.handlers[0].formatter._fmt
    assert hallthrusterpem_tpu_torch.get_logger("port_logger") is got and len(got.handlers) == 1
    assert hallthrusterpem_tpu_torch.__version__ == hallthrusterpem_tpu.__version__


@pytest.mark.parametrize("name,argv", [
    ("anchors", []), ("probe_uion", []), ("diagnose_current", []), ("probe_anom_shape", []),
    ("probe_anode_zone", []), ("tune_r5", ["-n", "2"]), ("diagnose_breathing", []), ("kernel_bench", ["2", "50"]),
])
def test_studies_need_a_card(name, argv, tmp_path, monkeypatch):
    """With no CUDA device and no ``--device``, each study raises before it
    solves or writes anything: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        globals()[name].main(argv)
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------- scoring: the same outputs in both

def _score_anchors(tmp_path, monkeypatch, jax_mod):
    out = _system_outputs(10, 101)
    jstub = _StubSystem(jyaml.load_system(jax_mod.CONFIG).inputs(), out)
    tstub = _StubSystem(load_system(_spt100.CONFIG, device="cpu").inputs(), _as_torch(out))
    monkeypatch.setattr(jyaml.YamlLoader, "load", staticmethod(lambda path: jstub))
    monkeypatch.setattr(anchors, "load_nominal_system", lambda device=None: tstub)
    assert jax_mod.main(["-o", str(tmp_path / "jax.json")]) == 1  # a NaN thrust fails its condition
    got = anchors.main(["-o", str(tmp_path / "port.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text())["conditions"] == json.loads(json.dumps(got["conditions"]))
    _close(jstub.batch, tstub.batch)
    assert got["platform"] == ref["platform"] == "cpu" and got["pass"] is ref["pass"] is False
    return got["conditions"], ref["conditions"]


def _score_probe_uion(tmp_path, monkeypatch, jax_mod):
    out = _system_outputs(3, 102)
    jstub = _StubSystem(jyaml.load_system(jax_mod.CONFIG).inputs(), out)
    tstub = _StubSystem(load_system(_spt100.CONFIG, device="cpu").inputs(), _as_torch(out))
    monkeypatch.setattr(jyaml.YamlLoader, "load", staticmethod(lambda path: jstub))
    monkeypatch.setattr(anchors, "load_nominal_system", lambda device=None: tstub)
    jax_mod.main(["-o", str(tmp_path / "jax")])
    got = probe_uion.main(["-o", str(tmp_path / "port"), "--device", "cpu"])
    _close(jstub.batch, tstub.batch)
    assert (tmp_path / "port" / "uion_probe.png").exists()
    return got, json.loads((tmp_path / "jax" / "uion_probe.json").read_text())


def _fake_run_simulation(outs: list, trees: list, torch_side: bool):
    def run(tree, *args, **kwargs):
        trees.append(tree)
        avg = outs[len(trees) - 1]
        return {"output": {"average": _as_torch(avg) if torch_side else avg}}
    return run


def _score_probe_anom_shape(tmp_path, monkeypatch, jax_mod):
    outs, jtrees, ttrees = [_rng_outputs(12, 202, 103)], [], []
    monkeypatch.setattr(jthruster, "run_simulation", _fake_run_simulation(outs, jtrees, False))
    monkeypatch.setattr(tthruster, "run_simulation", _fake_run_simulation(outs, ttrees, True))
    jax_mod.main(["-o", str(tmp_path / "jax"), "--pb", "3e-5"])
    got = probe_anom_shape.main(["-o", str(tmp_path / "port"), "--pb", "3e-5", "--device", "cpu"])
    _same_arrays(ttrees[0], jtrees[0])
    return got, json.loads((tmp_path / "jax" / "anom_shape_3e-05.json").read_text())


def _score_probe_anode_zone(tmp_path, monkeypatch, jax_mod):
    outs = [_rng_outputs(3, 202, 104 + i) for i in range(len(probe_anode_zone.CASES))]
    jtrees, ttrees = [], []
    monkeypatch.setattr(jthruster, "run_simulation", _fake_run_simulation(outs, jtrees, False))
    monkeypatch.setattr(tthruster, "run_simulation", _fake_run_simulation(outs, ttrees, True))
    jax_mod.main(["-o", str(tmp_path / "jax.json")])
    got = probe_anode_zone.main(["-o", str(tmp_path / "port.json"), "--device", "cpu"])
    for t, j in zip(ttrees, jtrees, strict=True):
        _same_arrays(t, j)
    return got, json.loads((tmp_path / "jax.json").read_text())


def _score_tune_r5(tmp_path, monkeypatch, jax_mod):
    cand, jcand = tune_r5.sample_candidates(4, seed=3), jax_mod.sample_candidates(4, seed=3)
    _close({k: v.tolist() for k, v in cand.items()}, {k: v.tolist() for k, v in jcand.items()})
    for box in ("wide", "refine"):
        a = tune_r5.sample_candidates(8, 1, tune_r5.BOX_REFINE if box == "refine" else None)
        b = jax_mod.sample_candidates(8, 1, jax_mod.BOX_REFINE if box == "refine" else None)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    out, jtrees, ttrees = _rng_outputs(12, 202, 105), [], []
    out["thrust"][3] = np.nan  # candidate 1 at 1e-5 Torr: its score is inf
    scale = np.random.default_rng(5).uniform(0.7, 1.3, (12, 1)).astype(np.float32)  # rel-L2 on both sides of 0.13
    out["ui"] = [u * scale for u in out["ui"]]
    monkeypatch.setattr(jthruster, "run_simulation", _fake_run_simulation([out], jtrees, False))
    monkeypatch.setattr(tthruster, "run_simulation", _fake_run_simulation([out], ttrees, True))
    jout = jax_mod.run_batch(jcand, 0.55, 1.5e-3, wall_recycling=0.9)
    tout = tune_r5.run_batch(cand, 0.55, 1.5e-3, wall_recycling=0.9, device="cpu")
    _same_arrays(ttrees[0], jtrees[0])
    jlif = {float(pb): r for pb, r in _jax_lif_rows().items()}
    ref = jax_mod.score_table(jcand, jout, jlif)
    got = tune_r5.score_table(cand, tout, _spt100.lif_rows())
    assert np.isinf(got[-1]["score"]) and np.isfinite(got[0]["score"])
    rel = [r for row in got for r in row["uion_rel_l2"]]
    assert min(rel) < 0.13 < max(rel), rel
    return got, ref


def _jax_lif_rows() -> dict:
    lif = np.genfromtxt(ROOT / "hallthrusterpem_tpu" / "data" / "spt100" / "uion_macdonald2019.csv",
                        delimiter=",", skip_header=1)
    return {pb: lif[lif[:, 0] == pb] for pb in np.unique(lif[:, 0])}


def _score_diagnose_current(tmp_path, monkeypatch, jax_mod, capsys=None):
    avg = _rng_outputs(1, 202, 106)
    avg["thrust"][:] = 0.08
    avg["ui"] = np.stack(avg["ui"], axis=1)
    calls = []

    def fake(torch_side):
        def dispatch(params, base_B, cfg, *args, **kwargs):
            calls.append((params, base_B, cfg))
            return _as_torch(avg) if torch_side else avg
        return dispatch

    argv = ["--wms", "0.5", "--anode-alpha", "0.05", "--b-max", "0.018", "--circuit-r", "0.7"]
    monkeypatch.setattr(jthruster, "dispatch_solver", fake(False))
    monkeypatch.setattr(tthruster, "dispatch_solver", fake(True))
    capsys.readouterr()
    jax_mod.main(argv + ["--cpu"])
    ref = capsys.readouterr().out.splitlines()
    diagnose_current.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    (jp, jB, jcfg), (tp, tB, tcfg) = calls
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    _same_config(tcfg, jcfg)
    assert got[0].startswith("# fidelity (2, 2) -> 200 cells, ncharge 3") and got[0].endswith("(cpu)")
    return got[1:], ref[1:]


@pytest.mark.parametrize("name", ["anchors", "probe_uion", "probe_anom_shape", "probe_anode_zone", "tune_r5",
                                  "diagnose_current"])
def test_scoring_matches_jax(name, tmp_path, monkeypatch, capsys):
    """The same model outputs scored by both packages: equal tables (within
    1e-12; ``diagnose_current``'s printed budget line for line) and equal solver
    inputs (batches, trees, configs, parameters)."""
    jax_mod = _jax_script(name)
    score = globals()[f"_score_{name}"]
    args = (tmp_path, monkeypatch, jax_mod) + ((capsys,) if name == "diagnose_current" else ())
    got, ref = score(*args)
    if name == "diagnose_current":
        assert len(got) > 30 and got == ref
    else:
        _close(json.loads(json.dumps(got)), ref)


# ---------------------------------------------------------------- short solves in both packages

def _shorten_tree(tree: dict) -> dict:
    sim = dict(tree["simulation"], duration=SHORT_DURATION, num_save=50,
               grid={"type": "EvenGrid", "num_cells": SHORT_CELLS})
    post = dict(tree["postprocess"], average_start_time=SHORT_DURATION / 2)
    return dict(tree, simulation=sim, postprocess=post)


def _short_run_simulation(orig, record: list):
    def run(tree, *args, **kwargs):
        out = orig(_shorten_tree(tree), *args, **kwargs)
        record.append(out["output"]["average"])
        return out
    return run


def _short_system(system):
    """The Thruster of a pem_v0 system cut to the short solve."""
    comp = system["Thruster"]
    comp.model_fidelity = ()
    sim = dict(comp.model_kwargs["simulation"], duration=SHORT_DURATION, num_save=50,
               grid={"type": "EvenGrid", "num_cells": SHORT_CELLS})
    comp.model_kwargs.update(simulation=sim, model_fidelity=None,
                             postprocess=dict(comp.model_kwargs["postprocess"],
                                              average_start_time=SHORT_DURATION / 2))
    return system


class _Recorder:
    """A System whose predict outputs are recorded."""

    def __init__(self, system):
        self.system, self.outs = system, []
        self.device = getattr(system, "device", torch.device("cpu"))

    def __getattr__(self, name):
        return getattr(self.system, name)

    def predict(self, *args, **kwargs):
        out = self.system.predict(*args, **kwargs)
        self.outs.append(out)
        return out


def _solve_system_script(name, tmp_path, monkeypatch, jax_mod):
    jsys = _Recorder(_short_system(jyaml.load_system(jax_mod.CONFIG)))
    tsys = _Recorder(_short_system(load_system(_spt100.CONFIG, device="cpu")))
    monkeypatch.setattr(jyaml.YamlLoader, "load", staticmethod(lambda path: jsys))
    monkeypatch.setattr(anchors, "load_nominal_system", lambda device=None: tsys)
    jax_mod.main(["-o", str(tmp_path / "jax")])
    globals()[name].main(["-o", str(tmp_path / "port"), "--device", "cpu"])
    (jout,), (tout,) = jsys.outs, tsys.outs
    np.testing.assert_array_equal(np.isnan(tout["T"].numpy()), np.isnan(np.asarray(jout["T"])))
    return [tout["thruster_output"]["output"]["average"]], [jout["thruster_output"]["output"]["average"]]


def _solve_sweep_script(name, tmp_path, monkeypatch, jax_mod):
    jrec, trec = [], []
    monkeypatch.setattr(jthruster, "run_simulation", _short_run_simulation(jthruster.run_simulation, jrec))
    monkeypatch.setattr(tthruster, "run_simulation", _short_run_simulation(tthruster.run_simulation, trec))
    if name == "tune_r5":
        jax_mod.main(["-n", "2", "-o", str(tmp_path / "jax.json")])
        tune_r5.main(["-n", "2", "-o", str(tmp_path / "port.json"), "--device", "cpu"])
    else:
        if name == "probe_anode_zone":  # two of the four cases: each is a new static config in JAX
            monkeypatch.setattr(jax_mod, "CASES", jax_mod.CASES[1:3])
            monkeypatch.setattr(probe_anode_zone, "CASES", probe_anode_zone.CASES[1:3])
        jax_mod.main(["-o", str(tmp_path / "jax")])
        globals()[name].main(["-o", str(tmp_path / "port"), "--device", "cpu"])
    return trec, jrec


def _solve_diagnose_current(name, tmp_path, monkeypatch, jax_mod):
    argv = ["--fidelity", "0", "0", "--duration", "5e-6"]
    ref = {}
    orig = jthruster.dispatch_solver

    def record(params, base_B, cfg):
        ref.update(orig(params, base_B, cfg))
        return ref

    monkeypatch.setattr(jthruster, "dispatch_solver", record)
    jax_mod.main(argv + ["--cpu"])
    got = diagnose_current.main(argv + ["--device", "cpu"])
    assert got["cfg"].num_cells == 100 and got["cfg"].num_steps <= 3000
    return [{k: v[None] for k, v in got["out"].items()}], [{k: np.asarray(v) for k, v in ref.items()}]


@pytest.mark.parametrize("name", ["anchors", "probe_uion", "probe_anom_shape", "probe_anode_zone", "tune_r5",
                                  "diagnose_current"])
def test_short_solves_match_jax(name, tmp_path, monkeypatch):
    """Each study's solve at 60 cells (``diagnose_current``: 100) for ~1,100
    steps in both packages: equal finite masks; thrust, discharge current and
    beam current within 1% on the rows finite in both."""
    jax_mod = _jax_script(name)
    solve = {"anchors": _solve_system_script, "probe_uion": _solve_system_script,
             "diagnose_current": _solve_diagnose_current}.get(name, _solve_sweep_script)
    gots, refs = solve(name, tmp_path, monkeypatch, jax_mod)
    assert len(gots) == len(refs) >= 1
    for got, ref in zip(gots, refs):
        for key in ("thrust", "discharge_current", "ion_current"):
            g = np.asarray(got[key].numpy() if isinstance(got[key], torch.Tensor) else got[key], np.float64)
            r = np.asarray(ref[key], np.float64)
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r), key)
            ok = np.isfinite(r)
            assert ok.sum() >= max(1, ok.size - 1), key
            assert np.max(np.abs(g[ok] / r[ok] - 1)) < QOI_TOL, (key, np.max(np.abs(g[ok] / r[ok] - 1)))


# ---------------------------------------------------------------- diagnose_breathing and kernel_bench

@pytest.mark.parametrize("flags", [[], ["--ncharge", "3", "--plume", "--shift", "--circuit-r", "0.5",
                                        "--implicit-inelastic"]], ids=["defaults", "three_charge_plume_shift"])
def test_diagnose_breathing_routes_match_jax(flags, tmp_path):
    """100 steps at 60 cells: the K-step route (``--every 50``), the lax route
    (``--every 25``) and JAX's lax snapshots agree within 1e-4 scaled at steps 50
    and 100; the statistics of both routes are computed on their snapshots."""
    base = ["--cells", "60", "--duration", "5e-7", *flags]
    _jax_script("diagnose_breathing").main(base + ["--cpu", "--every", "25", "--npz", str(tmp_path / "j.npz")])
    ref = dict(np.load(tmp_path / "j.npz"))
    kst = diagnose_breathing.main(base + ["--device", "cpu", "--every", "50", "--npz", str(tmp_path / "k.npz")])
    lax = diagnose_breathing.main(base + ["--device", "cpu", "--every", "25"])
    assert (kst["route"], lax["route"]) == ("kstep", "lax")
    assert set(dict(np.load(tmp_path / "k.npz"))) == set(ref)
    np.testing.assert_allclose(lax["t"], ref["t"], rtol=1e-12)
    np.testing.assert_allclose(lax["z"], ref["z"], rtol=1e-12)
    scaled = lambda a, b: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    for key in diagnose_breathing.SNAP_KEYS:
        assert lax["snaps"][key].shape == ref[key].shape, key
        for i_k, i_l in ((0, 1), (1, 3)):
            assert scaled(lax["snaps"][key][i_l], ref[key][i_l]) < SNAP_TOL, key
            assert scaled(kst["snaps"][key][i_k], ref[key][i_l]) < SNAP_TOL, key
            assert scaled(kst["snaps"][key][i_k], lax["snaps"][key][i_l]) < SNAP_TOL, key
    assert kst["stats"]["n_snap"] == 2 and lax["stats"]["n_snap"] == 4


def test_kernel_bench_matches_jax(monkeypatch, capsys):
    """JAX's micro-benchmark at B = 2, 100 steps (its Pallas kernel in
    interpret mode) against the port's: the same config and inputs, the same
    finite share and mean thrust within 1%."""
    import hallthrusterpem_tpu.models.thruster.pallas_step as ps

    orig, rec = ps.simulate_batch_pallas_multi, {}

    def once(params, base_B, cfg, **kw):
        if "out" not in rec:
            rec.update(inputs=(params, base_B, cfg), out=orig(params, base_B, cfg, interpret=True))
        return rec["out"]

    monkeypatch.setattr(ps, "simulate_batch_pallas_multi", once)
    monkeypatch.setattr(sys, "argv", ["kernel_bench.py", "2", "100"])
    runpy.run_path(str(ROOT / "scripts" / "kernel_bench.py"), run_name="__main__")
    got = kernel_bench.main(["2", "100", "--device", "cpu"])
    jp, jB, jcfg = rec["inputs"]
    cfg, params, base_B = kernel_bench.bench_inputs(2, 100, "cpu")
    for k in jp:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jp[k]), k)
    np.testing.assert_array_equal(base_B.numpy(), np.asarray(jB))
    _same_config(cfg, jcfg)
    th = np.asarray(rec["out"]["thrust"])
    assert got["device"] == "cpu" and len(got["reps"]) == kernel_bench.REPS == 3
    for r in got["reps"]:
        assert r["finite"] == float(np.isfinite(th).mean()) == 1.0
        assert abs(r["mean_T_mN"] / (np.nanmean(th) * 1e3) - 1) < QOI_TOL
    assert "us/step" in capsys.readouterr().out
