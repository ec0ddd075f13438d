"""The pem_v0 H9-class system through the port's normal path, on the CPU.

The packaged ``configs/pem_v0_H9.json`` at fidelity (2,2): 200 cells, 3 charge
states; GaussianBohm transport under a SimpleLogisticShift pressure response; no
ion wall losses, plume expansion or circuit. Its device is an effective 1-D
stand-in, not a measured geometry or field. The benchmark freezes it as
``pembench/configs/h9_pem_v0_a22.json`` for its cell ``h9_facility_sweep``.
Here: ``System.predict`` against the benchmark's plain reference
(``pembench/reference/pem_v0.py``, pointed at the port's device files), the
anomalous-transport profile against the JAX package's at a facility sweep's
four pressures, the frozen file against the packaged one, its work count, the
``gaussian_bohm_rows`` counter, the two traffic mixes the benchmark added with
it (``h9_pressure_sweep``, ``misc_refine``) and the ``consts_host_ms`` reader.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hallthrusterpem_tpu.models.thruster import config as jcfg
from hallthrusterpem_tpu.models.thruster import solver as jsolver
from hallthrusterpem_tpu_torch import tracing
from hallthrusterpem_tpu_torch.core.json_loader import config_dir, load_system
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.models.thruster import solver as tsolver

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pembench import traffic, work  # noqa: E402
from pembench.reference import pem_v0  # noqa: E402

H9 = config_dir() / "pem_v0_H9.json"
DEVICES = ROOT / "hallthrusterpem_tpu_torch" / "devices"
SPT100 = ROOT / "pembench" / "configs" / "spt100_pem_v0_a00.json"
FROZEN = ROOT / "pembench" / "configs" / "h9_pem_v0_a22.json"
#: the frozen file's own keys, beside the System document's
HEAD = ("source", "use_model", "fidelity", "what_runs", "device_status", "deployment", "reduced", "assumed",
        "reference", "work")
PRESSURES = (3e-6, 1e-5, 3e-5, 6e-5)  # Torr: P/P* 0.075-1.5, across the pressure shift's range


def _short(doc: dict, duration: float = 6.6e-7, num_save: int = 100) -> dict:
    """The document with its Thruster cut to ``duration`` (~300 steps at the
    H9 grid's 2.19e-9 s), averaged over the second half."""
    doc = copy.deepcopy(doc)
    thr = next(c for c in doc["components"] if c["name"] == "Thruster")
    thr["simulation"].update(duration=duration, num_save=num_save)
    thr["postprocess"]["average_start_time"] = 0.5 * duration
    return doc


def _system(path: Path, doc: dict):
    """``load_system`` on ``path`` with the Thruster's run as ``doc`` states it."""
    system = load_system(path, device="cpu")
    for comp, src in zip(system.components, doc["components"]):
        comp.model_kwargs.update({k: src[k] for k in ("simulation", "postprocess") if k in src})
    return system


def _sweep_rows(doc: dict, seed: int) -> dict:
    """Six rows of a facility sweep: the calibration and nuisance inputs from
    their distributions, two rows at each of the lowest and the highest
    pressure and one at each of the other two, at 300 V and 15 mg/s."""
    mix = {"rows_per_call": 6, "rest": "prior", "use_pdf": ["calibration", "nuisance"]}
    rows = traffic.Traffic(doc, mix, seed).call(0)
    rows["P_b"] = np.float32([3e-6, 1e-5, 3e-5, 6e-5, 3e-6, 6e-5])
    rows["V_a"], rows["mdot_a"] = np.full(6, 300, np.float32), np.full(6, 1.5e-5, np.float32)
    return rows


def test_predict_on_h9_matches_the_plain_reference(monkeypatch):
    """Every output the benchmark's check compares, over ~300 steps of the
    (2,2) grid. Both sides evaluate the same float32 expressions in the same
    order (the reference is a frozen copy of the kernel's plain equations), so
    they agree bit for bit, as they do for the SPT-100: the tolerance is 0."""
    monkeypatch.setattr(pem_v0, "DEVICES", DEVICES)
    doc = _short(json.loads(H9.read_text()))
    rows = _sweep_rows(doc, 2**31 + 7)
    out = _system(H9, doc).predict(rows, use_model="best")
    ref = pem_v0.predict(doc, rows, "best")
    assert pem_v0.grid_for(doc, rows, "best").num_cells == 200 and out["u_ion"].shape == (6, 202)
    assert np.isfinite(ref["T"]).all()
    for name, want in ref.items():
        got = out[name].detach().to(torch.float64).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def _h9_profile_params(n_per_pressure: int, seed: int) -> dict:
    """Solver parameters of the H9 transport closure: the four Gaussian-barrier
    inputs from their priors (``anom_max`` a ratio on ``anom_min``, as the input
    tree maps it), the configuration's SimpleLogisticShift, each pressure of the
    sweep ``n_per_pressure`` times."""
    doc = json.loads(H9.read_text())
    thr = next(c for c in doc["components"] if c["name"] == "Thruster")
    inputs = {v["name"]: v for v in thr["inputs"]}
    rng = np.random.default_rng(seed)
    n = 4 * n_per_pressure
    draw = lambda name: traffic.draw(inputs[name], rng, n)
    hall_min = draw("anom_min")
    anom = thr["config"]["anom_model"]
    over = {"P_b": np.tile(PRESSURES, n_per_pressure), "hall_min": hall_min,
            "hall_max": draw("anom_max") * hall_min, "center": draw("anom_center"), "width": draw("anom_width"),
            "shift_dz": np.full(n, anom["shift_length"]), "shift_pstar": np.full(n, anom["pstar"]),
            "shift_alpha": np.full(n, float(anom["alpha"]))}
    return {k: v.astype(np.float32) for k, v in over.items()}


def test_gaussian_bohm_profile_under_the_pressure_shift_matches_jax():
    """``solver.anomalous_profile`` for the H9 closure against the JAX
    package's, on the same numpy inputs at the sweep's four pressures: rtol
    1e-5, as the other profiles (both evaluate the same float32 expression; the
    sigmoid and exp may round in another order). The barrier sits downstream by
    0.25 L_ch at the lowest pressure and at its nominal place at the highest."""
    over = _h9_profile_params(8, 3)
    kw = dict(num_cells=200, ncharge=3, anom_model="GaussianBohm", pressure_shift="SimpleLogisticShift")
    geometry = json.loads((DEVICES / "H9" / "thruster.json").read_text())["geometry"]
    cj = jcfg.SolverConfig(**kw, geometry=jcfg.Geometry(**geometry))
    ct = tcfg.SolverConfig(**kw, geometry=tcfg.Geometry(**geometry))
    z = np.asarray(cj.cell_centers(), np.float32)
    ref = np.asarray(jax.vmap(lambda p: jsolver.anomalous_profile(p, jnp.asarray(z), cj))(jcfg.make_params(over)))
    pt = tcfg.make_params({k: torch.as_tensor(v) for k, v in over.items()}, device="cpu")
    got = tsolver.anomalous_profile(pt, torch.as_tensor(z), ct).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
    shift = tsolver._pressure_shift_m(pt, ct, ct.geometry.channel_length).numpy().reshape(-1, 4)
    full = 0.25 * ct.geometry.channel_length
    np.testing.assert_allclose(shift[:, 0], full, rtol=1e-4)  # P/P* = 0.075: sigmoid(-11.1) ~ 1.5e-5
    assert np.all(shift[:, 3] < 3e-3 * full)  # P/P* = 1.5: sigmoid(6) = 0.9975
    assert np.all(np.diff(shift, axis=1) < 0)
    floor = z[np.argmin(got, axis=1)].reshape(-1, 4)  # the barrier's floor follows the shift
    np.testing.assert_allclose(floor - over["center"].reshape(-1, 4), shift, atol=ct.dz)


def test_frozen_h9_file_is_the_packaged_system_but_for_its_cuts():
    """The frozen configuration equals ``configs/pem_v0_H9.json`` but for the
    keys its ``reduced`` and ``assumed`` list and the reference's model names,
    and its device files are the port's, byte for byte."""
    frozen = json.loads(FROZEN.read_text())
    packaged = json.loads(H9.read_text())
    assert {k: frozen[k] for k in ("use_model", "fidelity", "reference")} == {
        "use_model": "best", "fidelity": "(2, 2)", "reference": "pem_v0"}
    assert set(frozen["reduced"]) == {"Thruster.simulation.duration", "Thruster.postprocess.average_start_time"}
    assert set(frozen["assumed"]) == {"Thruster.simulation.num_save"}
    assert len(frozen["source"]) <= 200 and "stand-in" in frozen["device_status"]
    expected = copy.deepcopy(packaged)
    for comp in expected["components"]:
        comp["model"] = comp["model"].replace("hallthrusterpem_tpu.models.", "hallmd.models.")
    thr = {c["name"]: c for c in expected["components"]}
    for key, entry in {**frozen["reduced"], **frozen["assumed"]}.items():
        comp, *path = key.split(".")
        node = thr[comp]
        for part in path[:-1]:
            node = node[part]
        assert node.get(path[-1]) == entry["published"], key
        node[path[-1]] = entry["here"]
    assert {k: v for k, v in frozen.items() if k not in HEAD} == expected
    for name in ("thruster.json", "bfield_h9.csv"):
        assert (ROOT / "pembench/data/devices/H9" / name).read_bytes() == (DEVICES / "H9" / name).read_bytes()


def test_frozen_h9_work_is_counted_on_the_reference():
    doc = json.loads(FROZEN.read_text())
    rows = traffic.Traffic(doc, traffic.load_mix("h9_pressure_sweep"), 4).call(0)
    counted = work.count_config(doc, pem_v0, "best", {k: v[:3] for k, v in rows.items()})
    assert counted == doc["work"]
    spt100 = json.loads((ROOT / "pembench/configs/spt100_pem_v0_a22.json").read_text())["work"]
    assert counted["step_per_row"] < spt100["step_per_row"]  # no ion wall losses, no plume expansion


@pytest.mark.parametrize("config,gaussian", [(H9, True), (SPT100, False)])
def test_gaussian_bohm_rows_counts_the_rows_of_an_h9_call(config, gaussian):
    doc = _short(json.loads(config.read_text()), duration=4e-7, num_save=20)
    system = _system(config, doc)
    rows = traffic.Traffic(doc, {"rows_per_call": 5, "rest": "nominal"}, 1).call(0)
    before = dict(tracing.counts)
    system.predict(rows, use_model="best" if gaussian else doc["use_model"])
    change = {k: tracing.counts[k] - before[k] for k in ("gaussian_bohm_rows", "rows_attempted", "plume_eager_rows")}
    assert change["rows_attempted"] == change["plume_eager_rows"] == 5
    assert change["gaussian_bohm_rows"] == (5 if gaussian else 0)


def test_misc_refine_gives_its_rows_uniform_inside_their_domains():
    doc = json.loads(SPT100.read_text())
    spec = traffic.load_mix("misc_refine")
    gen = traffic.Traffic(doc, spec, 2**31 + 3)
    call = gen.call(1)
    assert gen.rows == spec["rows_per_call"] == 12 and not gen.conditions
    assert list(call) == list(traffic.exogenous_inputs(doc))
    for name, var in gen.inputs.items():
        values = call[name]
        assert values.shape == (12,) and values.dtype == np.float32 and np.isfinite(values).all(), name
        lo, hi = traffic.domain(var)
        slack = 1e-6 * (hi - lo)
        assert values.min() >= lo - slack and values.max() <= hi + slack, name
        assert np.unique(values).size == 12, name  # none held at its nominal


def test_h9_pressure_sweep_gives_its_rows_at_its_pressures():
    """256 rows at each of the four pressures, at 300 V and 15 mg/s; every
    other input drawn anew for every row inside its domain."""
    doc = json.loads(FROZEN.read_text())
    spec = traffic.load_mix("h9_pressure_sweep")
    gen = traffic.Traffic(doc, spec, 2**31 + 3)
    call = gen.call(1)
    assert gen.rows == spec["rows_per_call"] == 1024
    assert list(call) == list(traffic.exogenous_inputs(doc))
    for name, var in gen.inputs.items():
        values = call[name]
        assert values.shape == (1024,) and values.dtype == np.float32 and np.isfinite(values).all(), name
        if name in gen.conditions:
            np.testing.assert_array_equal(values, np.tile(gen.conditions[name], 256).astype(np.float32))
            continue
        lo, hi = traffic.domain(var)
        slack = 1e-6 * (hi - lo)
        assert values.min() >= lo - slack and values.max() <= hi + slack, name
        assert np.unique(values).size > 1000, name
    assert sorted(set(call["P_b"].tolist())) == np.float32(PRESSURES).tolist()
    assert all((call["P_b"] == np.float32(p)).sum() == 256 for p in PRESSURES)
    assert set(call["V_a"].tolist()) == {300.0} and set(call["mdot_a"].tolist()) == {np.float32(1.5e-5)}


def test_consts_host_ms_reads_the_consts_span(monkeypatch):
    """``pembench/metrics/consts_host_ms.py``: the mean host ms a completed call
    spends inside ``htpem.thruster.consts``; None where no call has that span,
    as on a program from before the span."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("consts_host_ms", ROOT / "pembench/metrics/consts_host_ms.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    ms = 1_000_000
    calls, spans = [], []
    for k, consts in enumerate((1.5, 2.5)):
        t0 = (k + 1) * 100 * ms
        spans += [("htpem.predict", t0, t0 + 50 * ms, {}), ("htpem.thruster.init", t0 + 10 * ms, t0 + 20 * ms, {}),
                  ("htpem.thruster.consts", t0 + 11 * ms, t0 + round((11 + consts) * ms), {})]
        calls.append({"ok": True, "end": (t0 + 50 * ms) * 1e-9, "wall_s": 50e-3})
    monkeypatch.setattr(tracing, "spans", spans)
    assert metric.read({"calls": calls}) == pytest.approx(2.0)
    monkeypatch.setattr(tracing, "spans", [s for s in spans if s[0] != "htpem.thruster.consts"])
    assert metric.read({"calls": calls}) is None


def _anom(doc: dict) -> dict:
    return next(c for c in doc["components"] if c["name"] == "Thruster")["config"]["anom_model"]


def _moved(doc: dict, rows: dict, fault: str):
    doc, rows = copy.deepcopy(doc), dict(rows)
    if fault == "shift dropped":
        _anom(doc)["shift_length"] = 0.0
    elif fault == "shift 10% short":
        _anom(doc)["shift_length"] *= 0.9
    elif fault == "P* 10% high":
        _anom(doc)["pstar"] *= 1.1
    elif fault == "anom_max ratio 10% low":
        rows["anom_max"] = (rows["anom_max"] * 0.9).astype(np.float32)
    else:  # the barrier's centre 1% downstream
        rows["anom_center"] = (rows["anom_center"] * 1.01).astype(np.float32)
    return doc, rows


@pytest.fixture(scope="module")
def h9_trace_start():
    """The reference over the cell's first ``trace_points`` trace samples
    (5e-8 s apart, ~460 steps), on two rows at each pressure of one call."""
    frozen = json.loads(FROZEN.read_text())
    points = json.loads((ROOT / "pembench/limits/h9_facility_sweep.json").read_text())["trace_points"]
    sim = next(c for c in frozen["components"] if c["name"] == "Thruster")["simulation"]
    doc = _short(frozen, duration=sim["duration"] / sim["num_save"] * points, num_save=points)
    call = traffic.Traffic(doc, traffic.load_mix("h9_pressure_sweep"), 2**31 + 11).call(0)
    rows = {k: v[:8] for k, v in call.items()}
    return doc, rows, pem_v0.predict(doc, rows, "best"), points


@pytest.mark.parametrize("fault", ["shift dropped", "shift 10% short", "P* 10% high", "anom_max ratio 10% low",
                                   "barrier centre 1% downstream"])
def test_h9_limits_fail_a_fault_in_the_transport_closure(h9_trace_start, fault):
    """A fault planted in what this configuration adds (the pressure shift, the
    Gaussian barrier) fails the cell's ``trace_gap`` limit over the trace's
    first samples, where the program reads ~1e-6 against the reference."""
    from pembench import check

    doc, rows, ref, points = h9_trace_start
    assert np.isfinite(ref["T"]).all()
    limits = check.load_limits("h9_facility_sweep")["limits"]
    got = pem_v0.predict(*_moved(doc, rows, fault), "best")
    numbers = check.readings(got, ref, points)
    assert numbers["trace_gap"] > 3 * limits["trace_gap"], numbers
    assert not check.judge(numbers, limits)[0]
