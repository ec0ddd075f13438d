"""Port against the JAX package: ``hallthrusterpem_tpu_torch.scripts.parity_tpu``
(the kernel against the lax solver) and the explicit solver route of
``dispatch_solver(..., solver=)``, on the CPU.

The script is held against ``scripts/parity_tpu.py``, loaded by file path.
Scoring: ``hallthruster_jl`` patched in both packages to return the same seeded
outputs per route (JAX picks its route from ``HTPEM_SOLVER``, the port from
``solver=``); the mask, attractor and per-QoI accounting must agree within
1e-12, on the same inputs and wrapper arguments. ``reeval`` of a copy of the
TPU artifact gives the same flags in both. The short solves run both routes in
both packages at 60 cells for about 1,100 steps (JAX: lax, and its Pallas
kernel in interpret mode; the port: lax, and the K-step plain version): equal
finite masks, thrust, discharge and beam current within 1% (the bound of
``tests/test_pallas.py::test_multistep_kernel_matches_lax``).
"""

import dataclasses
import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import hallthrusterpem_tpu.models.thruster as jthruster
import hallthrusterpem_tpu.models.thruster.pallas_step as jpallas
import hallthrusterpem_tpu_torch.models.thruster as tthruster
from hallthrusterpem_tpu_torch.models.thruster import _kernels
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.models.thruster import solver as tsol
from hallthrusterpem_tpu_torch.models.thruster.mapping import PEM_TO_JULIA, format_input_tree
from hallthrusterpem_tpu_torch.scripts import parity_tpu
from test_torch_system import ROOT

torch.set_num_threads(2)
SCORE_TOL = 1e-12
QOI_TOL = 1e-2
SHORT_CELLS = 60
SHORT_DURATION = 2.5e-6  # ~1,100 steps at the dt of fidelity (2,2)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_parity_tpu", ROOT / "scripts" / "parity_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == b or abs(a - b) <= SCORE_TOL * max(abs(a), abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_constants_match_jax():
    jax_mod = _jax_script()
    for name in ("TOLERANCES", "MIN_MASK_AGREEMENT", "MIN_ATTRACTOR_AGREEMENT", "MAX_REL_SAME_ATTRACTOR",
                 "CONFIGS"):
        assert getattr(parity_tpu, name) == getattr(jax_mod, name), name


def _route_outputs(batch: int, seed: int, case: str) -> dict:
    """Seeded wrapper outputs per route (numpy float64): the kernel's rows near
    the lax rows, some rows failed in one route only, some in another attractor."""
    rng = np.random.default_rng(seed)
    lax = {"T": 0.08 * (1 + rng.uniform(-0.1, 0.1, batch)), "I_d": 4.5 * (1 + rng.uniform(-0.1, 0.1, batch)),
           "I_B0": 3.6 * (1 + rng.uniform(-0.1, 0.1, batch))}
    drift = {"close": 0.005, "bulk": 0.04, "far": 0.2}[case]
    kern = {k: v * (1 + rng.normal(0, drift, batch)) for k, v in lax.items()}
    lax["T"][1] = np.nan
    kern["T"][[1, 4]] = np.nan
    if case != "close":
        kern["I_d"][5] *= 1.6  # another attractor
    return {"lax": lax, "pallas": kern}


@pytest.mark.parametrize("case", ["close", "bulk", "far"])
@pytest.mark.parametrize("cond", [c["name"] for c in parity_tpu.CONFIGS])
def test_scoring_matches_jax(cond, case, monkeypatch):
    """``run_config`` of both packages on the same patched wrapper outputs: the
    same entry (finite counts, agreements, per-QoI statistics and verdicts),
    and the same inputs and wrapper arguments for both routes."""
    jax_mod = _jax_script()
    batch, seed = 16, 11
    cfg = next(c for c in parity_tpu.CONFIGS if c["name"] == cond)
    outs = _route_outputs(batch, seed + len(cond), case)
    jcalls, tcalls = [], []

    def jax_fake(inputs, **kw):
        jcalls.append((os.environ["HTPEM_SOLVER"], inputs, kw))
        return dict(outs[os.environ["HTPEM_SOLVER"]])

    def port_fake(inputs, solver=None, device=None, **kw):
        tcalls.append((solver, inputs, kw))
        route = {"lax": "lax", "kstep": "pallas"}[solver]
        out = {k: torch.as_tensor(v) for k, v in outs[route].items()}
        out["thruster_output"] = format_input_tree(dict(inputs), PEM_TO_JULIA, **kw)
        return out

    monkeypatch.setattr(jthruster, "hallthruster_jl", jax_fake)
    monkeypatch.setattr(tthruster, "hallthruster_jl", port_fake)
    ref = jax_mod.run_config(cfg, batch, seed)
    got = parity_tpu.run_config(cfg, batch, seed, device="cpu")
    assert [c[0] for c in jcalls] == ["lax", "pallas"] and [c[0] for c in tcalls] == ["lax", "kstep"]
    for (_, ji, jkw), (_, ti, tkw) in zip(jcalls, tcalls):
        assert set(ti) == set(ji)
        for k in ji:
            np.testing.assert_array_equal(ti[k].numpy(), ji[k], k)
        assert tkw == jkw
    assert got["wall_s"].keys() == ref["wall_s"].keys()
    assert got["kstep_launches"] == 0 and got["lax_ms_per_step"] > 0
    assert 800_000 < got["steps"] < 1_200_000  # 2e-3 s at the adaptive dt of fidelity (2,2)
    for key in ("wall_s", "steps", "lax_ms_per_step", "kstep_launches"):
        got.pop(key)
    ref.pop("wall_s")
    _close(json.loads(json.dumps(got)), json.loads(json.dumps(ref)))
    if case == "close":
        assert got["pass"]
    if case == "far":
        assert not got["pass"]


def test_reeval_matches_jax(tmp_path, capsys):
    """``reeval`` of the TPU artifact (``runs/r4/parity_tpu.json``) and of a copy
    with one QoI pushed past its median tolerance: the same flags and printed
    lines in both packages."""
    jax_mod = _jax_script()
    src = ROOT / "runs" / "r4" / "parity_tpu.json"
    art = json.loads(src.read_text())
    bad = json.loads(src.read_text())
    bad["configs"][0]["qois"]["T"]["median_rel"] = 0.5
    for name, doc in (("tpu", art), ("bad", bad)):
        for side in ("jax", "port"):
            (tmp_path / f"{name}_{side}.json").write_text(json.dumps(doc))
        capsys.readouterr()
        rc_ref = jax_mod.reeval(tmp_path / f"{name}_jax.json")
        out_ref = capsys.readouterr().out.replace(f"{name}_jax", f"{name}_port")
        rc_got = parity_tpu.reeval(tmp_path / f"{name}_port.json")
        assert rc_got == rc_ref and capsys.readouterr().out == out_ref
        assert (json.loads((tmp_path / f"{name}_port.json").read_text())
                == json.loads((tmp_path / f"{name}_jax.json").read_text()))
    assert json.loads((tmp_path / "bad_port.json").read_text())["pass"] is False


def _short_run_simulation(orig, record: list):
    def run(tree, *args, **kwargs):
        sim = dict(tree["simulation"], duration=SHORT_DURATION, grid={"type": "EvenGrid", "num_cells": SHORT_CELLS})
        post = dict(tree["postprocess"], average_start_time=SHORT_DURATION / 2)
        out = orig(dict(tree, simulation=sim, postprocess=post), *args, **kwargs)
        record.append(out["output"]["average"])
        return out
    return run


@pytest.mark.parametrize("cond", ["nominal_300V_5.16mg", "two_group_nominal"])
def test_short_solves_match_jax(cond, monkeypatch):
    """Both routes in both packages at 60 cells, ~1,100 steps, B = 4: the same
    finite masks and accounting of finite rows, and each route's unguarded
    thrust, discharge and beam current within 1% of JAX's."""
    jax_mod = _jax_script()
    cfg = next(c for c in parity_tpu.CONFIGS if c["name"] == cond)
    jrec, trec = [], []
    monkeypatch.setattr(jthruster, "run_simulation", _short_run_simulation(jthruster.run_simulation, jrec))
    monkeypatch.setattr(tthruster, "run_simulation", _short_run_simulation(tthruster.run_simulation, trec))
    monkeypatch.setattr(jpallas, "simulate_batch_pallas_multi",
                        functools.partial(jpallas.simulate_batch_pallas_multi, interpret=True))
    _kernels.reset_counts()
    ref = jax_mod.run_config(cfg, 4, 11)
    got = parity_tpu.run_config(cfg, 4, 11, device="cpu")
    assert got["finite"] == ref["finite"]
    assert 1000 < got["steps"] < 1200 and got["kstep_launches"] == 0  # the plain version on the CPU
    for route, (t_avg, j_avg) in zip(("lax", "kstep"), zip(trec, jrec)):
        for key in ("thrust", "discharge_current", "ion_current"):
            g, r = t_avg[key].numpy(), np.asarray(j_avg[key])
            assert np.all(np.isfinite(r)), (route, key)
            assert np.max(np.abs(g - r) / np.abs(r)) < QOI_TOL, (route, key)


def test_parity_main_writes_the_artifact(tmp_path, monkeypatch):
    """``main`` on the CPU (the wrapper patched): one entry per config, the
    device record, the overall verdict, and ``--reeval`` of what it wrote."""
    outs = _route_outputs(8, 3, "close")

    def port_fake(inputs, solver=None, device=None, **kw):
        out = {k: torch.as_tensor(v) for k, v in outs["lax" if solver == "lax" else "pallas"].items()}
        out["thruster_output"] = format_input_tree(dict(inputs), PEM_TO_JULIA, **kw)
        return out

    monkeypatch.setattr(tthruster, "hallthruster_jl", port_fake)
    path = tmp_path / "parity.json"
    assert parity_tpu.main(["-o", str(path), "-B", "8", "--device", "cpu"]) == 0
    art = json.loads(path.read_text())
    assert [e["condition"]["name"] for e in art["configs"]] == [c["name"] for c in parity_tpu.CONFIGS]
    assert art["platform"] == "cpu" and art["power_limit"] is None and art["pass"] is True
    assert parity_tpu.main(["-o", str(path), "--reeval"]) == 0


# ---------------------------------------------------------------- the explicit route

def _route_setup(num_cells=60, dtype="float32"):
    cfg = tcfg.SolverConfig(num_cells=num_cells, ncharge=3, dt=8e-9, duration=40 * 8e-9,
                            average_start_time=20 * 8e-9, dtype=dtype)
    params = tcfg.make_params({"V_d": torch.tensor([290.0, 310.0]), "V_cc": 30.0, "mdot_a": 5e-6})
    z = torch.as_tensor(cfg.cell_centers(), dtype=torch.float32)
    return cfg, params, 0.016 * torch.exp(-0.5 * ((z - 0.025) / 0.011) ** 2)


@pytest.mark.parametrize("route", [None, "kstep", "lax"])
def test_dispatch_solver_route(route, monkeypatch):
    """On a config the kernel takes: ``None`` and ``"kstep"`` run the K-step
    (plain on the CPU) and equal each other; ``"lax"`` runs the lax solver and
    equals ``solver.simulate_batch`` bit for bit, no K-step block run."""
    cfg, params, base_B = _route_setup()
    blocks = []
    orig = tthruster.fs.kstep_plain
    monkeypatch.setattr(tthruster.fs, "kstep_plain", lambda *a: blocks.append(1) or orig(*a))
    out = tthruster.dispatch_solver(params, base_B, cfg, solver=route)
    if route == "lax":
        ref = tsol.simulate_batch(params, base_B, cfg)
        assert not blocks
    else:
        ref = tthruster.fs.simulate_batch_multi(params, base_B, cfg)
        assert blocks
    assert set(out) == set(ref)
    for k in ref:
        assert torch.equal(torch.nan_to_num(out[k]), torch.nan_to_num(ref[k])), k


@pytest.mark.parametrize("num_cells,dtype", [(300, "float32"), (60, "float64")])
def test_kstep_route_refuses_what_the_kernel_cannot_take(num_cells, dtype):
    """``solver="kstep"`` past 254 cells or in float64 raises, naming the lax
    solver; ``solver="lax"`` runs the same config; an unknown route raises."""
    cfg, params, base_B = _route_setup(num_cells, dtype)
    base_B = torch.full((cfg.nc,), 0.01)
    with pytest.raises(NotImplementedError, match="lax solver"):
        tthruster.dispatch_solver(params, base_B, cfg, solver="kstep")
    short = dataclasses.replace(cfg, duration=4 * cfg.dt, average_start_time=0.0)
    out = tthruster.dispatch_solver(params, base_B, short, solver="lax")
    assert out["thrust"].dtype == getattr(torch, dtype)
    with pytest.raises(ValueError, match="solver="):
        tthruster.dispatch_solver(params, base_B, short, solver="pallas")


def test_run_simulation_threads_the_route(monkeypatch):
    """``hallthruster_jl(..., solver=)`` reaches ``dispatch_solver`` through
    ``run_simulation``, and ``simulate_batch_sharded`` passes it to each shard."""
    from hallthrusterpem_tpu_torch.parallel.mesh import Mesh

    seen = []
    orig = tthruster.dispatch_solver
    monkeypatch.setattr(tthruster, "dispatch_solver",
                        lambda *a, solver=None, **k: seen.append(solver) or orig(*a, solver=solver, **k))
    x = {"V_a": torch.tensor([300.0, 310.0]), "mdot_a": torch.tensor([5e-6, 5e-6])}
    kw = dict(thruster="SPT-100", model_fidelity=(0, 0), simulation={"duration": 2e-8},
              postprocess={"average_start_time": 1e-8}, device="cpu")
    tthruster.hallthruster_jl(x, solver="lax", **kw)
    tthruster.hallthruster_jl(x, solver="kstep", mesh=Mesh(["cpu"] * 2), **kw)
    assert seen == ["lax", "kstep", "kstep"]
