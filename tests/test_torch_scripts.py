"""Port against the JAX package: the workflow scripts of
``hallthrusterpem_tpu_torch/scripts`` (gen_data -> fit_surr -> plot_slice, the
surrogate-campaign tools, validate_solver, debug, install_solver), on a JSON
copy of ``tests/fake_pem.yml`` and on the CPU (``--device cpu``).

Each is held against its counterpart in ``scripts/``: the same numpy outputs
give the same NaN and outlier masks; the same snapshots give compression maps
of equal rank whose projectors ``P P^T`` agree within 1e-8 in float64 (the
SVD's signs are free); the masks the validity post-pass writes are equal; the
failure classifiers fitted on both packages' test sets agree within 1e-6; the
report of the r5 trained ensemble lies within 5e-4 of ``runs/r5/surr/report.json``
(which rounds to 4 decimals); the validation sweep's guard masks are equal and
its thrust and currents within 1% of JAX's (lax, on the CPU). The pickles the
scripts write hold numpy only, and each package reads the other's.
"""

import importlib.util
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from hallthrusterpem_tpu.core import yaml_loader as jyaml
from hallthrusterpem_tpu_torch.constants import FUNDAMENTAL_CHARGE
from hallthrusterpem_tpu_torch.core.json_loader import config_dir, load_system
from hallthrusterpem_tpu_torch.scripts import (debug, fit_surr, gen_data, gen_mlp_data, install_solver,
                                               plot_slice, remask_validity, surr_report, trim_domain,
                                               validate_solver)
from test_torch_system import ROOT, yaml_as_json_doc

torch.set_num_threads(2)
FAKE_YML = ROOT / "tests" / "fake_pem.yml"
R5 = ROOT / "runs" / "r5" / "surr"
CPU = ["--device", "cpu"]


def _jax_script(name: str):
    """A script of ``scripts/`` as a module of its own name (``jax_<name>``)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_only(node) -> bool:
    if isinstance(node, dict):
        return all(_numpy_only(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return all(_numpy_only(v) for v in node)
    return isinstance(node, (np.ndarray, np.generic, int, float, str, bool, type(None)))


def _load(path):
    with open(path, "rb") as fd:
        return pickle.load(fd)


def _json_copy(tmp_path) -> Path:
    path = tmp_path / "fake_pem.json"
    path.write_text(json.dumps(yaml_as_json_doc(FAKE_YML)))
    return path


@pytest.fixture()
def workdir(tmp_path):
    _json_copy(tmp_path)
    return tmp_path


def test_pipeline_gen_fit_slice(workdir, monkeypatch):
    cfg = str(workdir / "fake_pem.json")
    gen_data.main([cfg, "-c", "48", "-t", "32", *CPU])
    data_dir = workdir / "amisc_data"
    for name in ("compression.pkl", "test_set.pkl"):
        d = _load(data_dir / name)
        assert set(d) == {"samples", "outputs", "discard", "nan_idx", "outlier_idx"} and _numpy_only(d), name
    comp = data_dir / "fake-pem_compression.json"
    assert comp.exists()

    system = load_system(comp, device="cpu")
    uvar = system["Thruster"]["u_ion"]
    assert uvar.compression.projection is not None and uvar.compression.latent_size >= 1

    fit_surr.main([str(comp), "--surrogate", "misc", "-i", "6", "-m", "1e-8", "-N", "64", *CPU])
    trained = data_dir / "fake-pem_trained.json"
    assert trained.exists()
    s2 = load_system(trained, device="cpu")
    assert all(c.surrogate is not None for c in s2.components)
    assert len(s2.train_history) >= 1
    out = s2.predict(s2.sample_inputs(16, seed=9), use_model=None, training=True)
    assert np.isfinite(out["T"].numpy()).all()

    monkeypatch.chdir(workdir)
    plot_slice.main([str(data_dir), "--search", "-i", "P_b", "V_a", "-o", "T", "I_d", "-n", "7",
                     "--save", str(workdir / "slice.png"), *CPU])
    assert (workdir / "slice.png").exists()


def test_gen_data_plots(workdir):
    gen_data.main([str(workdir / "fake_pem.json"), "-c", "24", "-t", "12", "--plots", *CPU])
    data_dir = workdir / "amisc_data"
    assert (data_dir / "compression_u_ion.png").exists()
    assert (data_dir / "test_set_outliers.png").exists()


def test_filter_outputs_reference_semantics():
    """NaN-only discard by default; the IQR screens outputs, never inputs; and
    JAX's ``filter_outputs`` gives the same masks on the same outputs."""
    rng = np.random.default_rng(0)
    n = 400
    # a log-uniform input spanning 4 decades: a linear IQR would flag its tails
    c4 = 10 ** rng.uniform(18, 22, n)
    y = rng.normal(1.0, 0.1, n)
    y[7] = np.nan  # a failure
    y[11] = 50.0  # an outlier
    field = rng.normal(0.0, 1.0, (n, 6))
    field[20] += 40.0  # every point out: a field outlier
    field[21, :2] += 40.0  # a third of its points: not one
    y[20] = y[21] = 1.0
    field[30, 3] = np.nan
    outputs = {"c4": c4, "T": y, "u_ion": field, "u_ion_coords": np.tile(np.linspace(0, 1, 6), (n, 1)),
               "model_cost": np.full(n, 1e9)}
    nan_idx, outlier_idx = gen_data.filter_outputs(outputs, 1.5, skip={"c4"})
    assert nan_idx.sum() == 2 and nan_idx[7] and nan_idx[30]
    assert outlier_idx[11] and outlier_idx[20] and not outlier_idx[21] and not outlier_idx[7]
    _, out_all = gen_data.filter_outputs(outputs, 1.5)
    assert out_all.sum() > 50  # why inputs must be skipped
    jgen = _jax_script("gen_data")
    for skip in ({"c4"}, None):
        for factor in (1.5, 3.0):
            got = gen_data.filter_outputs(outputs, factor, skip=skip)
            ref = jgen.filter_outputs(outputs, factor, skip=skip)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)


def test_process_compression_matches_jax(tmp_path):
    """The same snapshots (the fake PEM's outputs, one row NaN) through both
    packages' ``process_compression``: equal ranks, projectors within 1e-8."""
    tsys = load_system(_json_copy(tmp_path), device="cpu")
    jsys = jyaml.load_system(FAKE_YML)
    x = tsys.sample_inputs(40, seed=4, use_pdf=["calibration", "nuisance"])
    outputs = {k: v.numpy().astype(np.float64) for k, v in tsys.predict(x, use_model="best").items()
               if isinstance(v, torch.Tensor) and v.is_floating_point() and v.ndim >= 1}
    outputs["u_ion"][5] = np.nan
    nan_idx, _ = gen_data.filter_outputs(outputs, skip=set(x))
    assert nan_idx[5]
    gen_data.process_compression(tsys, outputs, nan_idx)
    _jax_script("gen_data").process_compression(jsys, outputs, nan_idx)
    compared = 0
    for comp in tsys.components:
        for var in comp.outputs:
            if var.compression is None:
                continue
            tc, jc = var.compression, jsys[comp.name][var.name].compression
            assert tc.rank == jc.rank >= 1, var.name
            P, Q = np.asarray(tc.projection, np.float64), np.asarray(jc.projection, np.float64)
            assert np.max(np.abs(P @ P.T - Q @ Q.T)) < 1e-8, var.name
            np.testing.assert_array_equal(tc.coords, np.asarray(jc.coords))
            compared += 1
    assert compared >= 1


def test_mlp_surrogate_pipeline(workdir):
    """``--surrogate mlp``: labelling (resumable cache), training, rel-L2,
    the save, and the surrogate path through ``System.predict`` against
    ``as_torch_fn``."""
    gen_data.main([str(workdir / "fake_pem.json"), "-c", "48", "-t", "64", *CPU])
    data_dir = workdir / "amisc_data"
    comp = data_dir / "fake-pem_compression.json"
    fit_surr.main([str(comp), "--surrogate", "mlp", "--mlp-samples", "512", "--mlp-steps", "2000",
                   "--mlp-hidden", "64", "64", "--mlp-ensemble", "3", "--mlp-chunk", "256", *CPU])
    cache = data_dir / "fake-pem_mlp_train_data.pkl"
    assert cache.exists() and _numpy_only(_load(cache))

    s2 = load_system(data_dir / "fake-pem_trained.json", device="cpu")
    assert s2.system_surrogate is not None
    xt, yt = fit_surr.load_test_set(comp)
    errors = s2.system_surrogate.test_errors(xt, yt)
    assert errors["T"] < 0.15, errors
    assert errors["I_d"] < 0.15, errors

    fresh = s2.sample_inputs(8, seed=3)
    out_host = s2.predict(fresh, use_model=None)
    out_dev = s2.as_torch_fn()({k: v for k, v in fresh.items()})
    np.testing.assert_allclose(out_host["T"].numpy(), out_dev["T"].numpy(), rtol=1e-5)
    assert "sys_fail_prob" in out_dev
    assert float(out_dev["sys_fail_prob"].max()) < 0.5  # the fake model never fails


def test_gen_mlp_data_cache_read_by_both(workdir):
    """A per-seed cache of ``gen_mlp_data`` beside ``fit_surr``'s: numpy only,
    and both packages' ``load_training_caches`` concatenate the same rows."""
    from hallthrusterpem_tpu.surrogate.mlp import load_training_caches as jax_load
    from hallthrusterpem_tpu_torch.surrogate.mlp import generate_training_data, load_training_caches

    gen_data.main([str(workdir / "fake_pem.json"), "-c", "16", "-t", "8", *CPU])
    data_dir = workdir / "amisc_data"
    system = load_system(data_dir / "fake-pem_compression.json", device="cpu")
    generate_training_data(system, 24, seed=7, chunk=16, cache_path=data_dir / "fake-pem_mlp_train_data.pkl")
    path = gen_mlp_data.main(["-n", "40", "--seed", "3", "--chunk", "32", "--dir", str(data_dir),
                              "--config", "fake-pem_compression.json", *CPU])
    assert path == data_dir / "fake-pem_mlp_train_data_s3.pkl"
    cache = _load(path)
    assert cache["n"] == cache["done"] == 40 and cache["seed"] == 3 and _numpy_only(cache)
    samples, outputs = load_training_caches(data_dir, system)
    jsamples, joutputs = jax_load(data_dir, jyaml.load_system(FAKE_YML))
    assert len(samples["V_a"]) == 64 and set(samples) == set(jsamples) and set(outputs) == set(joutputs)
    for k in outputs:
        np.testing.assert_array_equal(np.asarray(joutputs[k]), outputs[k])


def test_remask_validity_mask(tmp_path):
    """The discharge-current validity rule: I_d / I_eq outside [0.2, 8] is a
    failure; and ``main`` rewrites a cache and a test set as JAX's does."""
    mdot = np.full(5, 5e-6)
    i_eq = 1.602176634e-19 * 5e-6 / 2.1801714e-25  # ~3.67 A
    i_d = np.array([0.05 * i_eq, 0.5 * i_eq, 6.0 * i_eq, 16.0 * i_eq, np.nan])
    bad = remask_validity.validity_mask(i_d, mdot)
    assert bad.tolist() == [True, False, False, True, False]  # NaN rows are masked already
    np.testing.assert_array_equal(bad, _jax_script("remask_validity").validity_mask(i_d, mdot))

    rng = np.random.default_rng(2)
    n = 64
    mdot = rng.uniform(3e-6, 6e-6, n)
    # I_d / (e mdot / m_i) across the validity band and past both of its ends
    i_d = 10 ** rng.uniform(np.log10(0.05), np.log10(20.0), n) * FUNDAMENTAL_CHARGE * mdot / 2.1801714e-25
    i_d[3] = np.nan
    cache = {"n": n + 8, "seed": 0, "done": n, "outputs": {
        "I_d": np.concatenate([i_d, np.ones(8)]), "mdot_a": np.concatenate([mdot, np.ones(8)]),
        "T": rng.uniform(0.05, 0.1, n + 8), "u_ion": rng.normal(size=(n + 8, 5)),
        "u_ion_coords": np.tile(np.linspace(0, 1, 5), (n + 8, 1)), "model_cost": np.ones(n + 8),
        "V_a": rng.uniform(200, 400, n + 8)}}
    test = {"samples": {"mdot_a": mdot, "V_a": rng.uniform(200, 400, n)},
            "outputs": {"I_d": i_d, "T": rng.uniform(0.05, 0.1, n), "u_ion": rng.normal(size=(n, 5))},
            "discard": ~np.isfinite(i_d), "nan_idx": ~np.isfinite(i_d), "outlier_idx": np.zeros(n, bool)}
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for d in (port_dir, jax_dir):
        d.mkdir()
        for name, obj in (("pem_v0_SPT-100_mlp_train_data.pkl", cache), ("test_set.pkl", test)):
            with open(d / name, "wb") as fd:
                pickle.dump(obj, fd)
    shutil.copy(config_dir() / "pem_v0_SPT-100_compression.json", port_dir)
    for name in ("pem_v0_SPT-100_compression.yml", "pem_v0_SPT-100_compression.yml.state.pkl"):
        shutil.copy(R5 / name, jax_dir)
    remask_validity.main([str(port_dir), *CPU])
    _jax_script("remask_validity").main([str(jax_dir)])
    for name in ("pem_v0_SPT-100_mlp_train_data.pkl", "test_set.pkl"):
        got, ref = _load(port_dir / name), _load(jax_dir / name)
        assert _numpy_only(got)
        for part in ("outputs", "samples"):
            for k, v in ref.get(part, {}).items():
                np.testing.assert_array_equal(np.isnan(got[part][k]), np.isnan(v), err_msg=f"{name} {k}")
        for k in ("discard", "nan_idx"):
            if k in ref:
                np.testing.assert_array_equal(got[k], ref[k])
    remasked = _load(port_dir / "test_set.pkl")["nan_idx"]
    assert 0 < remasked.sum() < n


def test_trim_domain_matches_jax(tmp_path, workdir):
    """``trim_domain`` on both packages' ``test_set.pkl`` (a failure boundary
    planted at high V_a in both): the port's and JAX's classifiers agree within
    1e-6 on a fixed grid, each reading the other's pickle."""
    gen_data.main([str(workdir / "fake_pem.json"), "-c", "8", "-t", "96", "-o", str(tmp_path / "port"), *CPU])
    shutil.copy(FAKE_YML, tmp_path / "fake_pem.yml")
    _jax_script("gen_data").main([str(tmp_path / "fake_pem.yml"), "-c", "8", "-t", "96", "-o",
                                  str(tmp_path / "jax")])
    pkls = []
    for d in ("port", "jax"):
        path = tmp_path / d / "test_set.pkl"
        test = _load(path)
        fail = np.asarray(test["samples"]["V_a"]) > 340.0
        test["outputs"]["T"] = np.where(fail, np.nan, test["outputs"]["T"])
        with open(path, "wb") as fd:
            pickle.dump(test, fd)
        pkls.append(str(path))
    tclf, tpath = trim_domain.main([str(workdir / "fake_pem.json"), *pkls, "-o", str(tmp_path / "t.pkl"),
                                    "--steps", "400", *CPU])
    _jax_script("trim_domain").main([str(tmp_path / "fake_pem.yml"), *pkls, "-o", str(tmp_path / "j.pkl"),
                                     "--steps", "400"])
    from hallthrusterpem_tpu.surrogate.domain import FailureClassifier as JaxClassifier

    jclf = JaxClassifier.load(tmp_path / "j.pkl")
    assert tpath == tmp_path / "t.pkl" and _numpy_only(_load(tpath))
    assert tclf.var_names == jclf.var_names
    X = np.asarray(jclf.x_mu) + np.asarray(jclf.x_sd) * np.random.default_rng(1).uniform(
        -2, 2, (256, len(jclf.var_names)))
    p_port, p_jax = tclf.prob(X), jclf.prob(X)
    assert np.max(np.abs(p_port - p_jax)) < 1e-6
    assert p_port.min() < 0.1 and p_port.max() > 0.9  # the planted boundary was learnt


def test_surr_report_r5(tmp_path):
    """The report of the r5 trained ensemble (loaded by ``load_state`` onto the
    packaged compression config) on r5's test set: every rel-L2, and I_d's
    global one, within 5e-4 of the committed ``report.json``."""
    out = tmp_path / "report.json"
    rep = surr_report.main([str(R5), "-o", str(out), "--config", "pem_v0_SPT-100_compression.json", *CPU])
    ref = json.loads((R5 / "report.json").read_text())
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep))
    assert rep["n_test"] == ref["n_test"] == 1868
    assert set(rep["rel_l2"]) == set(ref["rel_l2"])
    for k, v in ref["rel_l2"].items():
        assert abs(rep["rel_l2"][k] - v) <= 5e-4, (k, rep["rel_l2"][k], v)
    assert abs(rep["I_d"]["global_rel_l2"] - ref["I_d"]["global_rel_l2"]) <= 5e-4
    # the other numbers of the report: counts equal, the rest within 1e-3 (a
    # coverage moves by 1/n when one row crosses its bound)
    for part in ("I_d", "eta_c"):
        for k, v in ref[part].items():
            got = rep[part][k]
            if k == "binned_calibration":
                assert [sorted(b) for b in got] == [sorted(b) for b in v] and len(got) == len(v)
                for gb, rb in zip(got, v):
                    assert gb["n_eval"] == rb["n_eval"]
                    assert all(abs(gb[f] - rb[f]) <= 1e-3 for f in ("spread_lo", "tau", "coverage_2sigma")), gb
            elif isinstance(v, (str, list)) or k.endswith("_n"):
                assert got == v, (part, k)
            else:
                assert abs(got - v) <= 1e-3, (part, k, got, v)


def test_debug_script_cpu(capsys):
    rec = debug.main(["--cpu"])
    assert rec["mesh"] == ["cpu"] * 8 and rec["samples"] == 35
    assert "BatchExecutor over 8 devices: OK" in capsys.readouterr().out


def test_install_solver_cpu(capsys):
    rec = install_solver.main(["--device", "cpu", "--batch", "2", "--duration", "2e-7",
                               "--fidelities", "(0, 0)", "(1, 1)"])
    assert rec["build"] == {}
    assert [(f["cells"], f["ncharge"], f["finite"]) for f in rec["fidelities"]] == [(100, 1, 2), (150, 2, 2)]
    assert "plain solver ready" in capsys.readouterr().out


def test_validate_solver_sweep_matches_jax():
    """The sweep at 60 cells and 2e-5 s (4,000 steps) against JAX's
    ``dispatch_solver`` on the same config and params (lax on the CPU): equal
    guard masks; thrust, I_d and I_B0 within 1% on the rows finite in both."""
    import jax.numpy as jnp

    from hallthrusterpem_tpu.models.thruster import _load_bfield as jax_bfield
    from hallthrusterpem_tpu.models.thruster import dispatch_solver as jax_dispatch
    from hallthrusterpem_tpu.models.thruster.config import SolverConfig as JaxConfig
    from hallthrusterpem_tpu.models.thruster.config import make_params as jax_params
    from hallthrusterpem_tpu.utils import load_thruster as jax_thruster

    res = validate_solver.sweep(2e-5, 60, 1, "cpu")
    cfg = res["cfg"]
    assert cfg.num_steps == 4000 and res["out"]["thrust"].shape == (10,)
    jcfg = JaxConfig(num_cells=60, ncharge=1, dt=cfg.dt, duration=2e-5, average_start_time=1e-5,
                     solve_plume=True, apply_thrust_divergence_correction=True,
                     pressure_shift="LogisticPressureShift")
    params = jax_params(dict(validate_solver.NOMINAL, V_d=res["VD"].ravel().astype(np.float32),
                             mdot_a=res["MD"].ravel().astype(np.float32)))
    base_B = jnp.asarray(jax_bfield(jax_thruster("SPT-100"), jcfg), jnp.float32)
    ref = {k: np.asarray(v) for k, v in jax_dispatch(params, base_B, jcfg).items()}
    i_max = 1.5 * FUNDAMENTAL_CHARGE * res["MD"].ravel() / jcfg.mi
    ref_bad = ((ref["ion_current"] < 0) | (ref["discharge_current"] < 0) | (ref["mass_eff"] < 0)
               | (ref["ion_current"] > i_max) | ~np.isfinite(ref["thrust"]))
    np.testing.assert_array_equal(res["bad"], ref_bad)
    for key in ("thrust", "discharge_current", "ion_current"):
        got, want = res["out"][key], ref[key]
        ok = np.isfinite(got) & np.isfinite(want)
        assert ok.sum() >= 8, key
        assert np.max(np.abs(got[ok] / want[ok] - 1)) < 1e-2, key


def test_validate_solver_trend_checks():
    """The trend asserts: a map rising with V_d and mass flow passes (NaN-masked
    rows skipped); one whose thrust falls with mass flow raises."""
    VD, MD = np.meshgrid(validate_solver.SWEEP_VD, validate_solver.SWEEP_MDOT, indexing="ij")
    thrust = (1e-5 * VD * MD / 5e-6).ravel()
    bad = np.zeros(VD.size, bool)
    bad[3] = True
    res = {"VD": VD, "out": {"thrust": thrust}, "bad": bad}
    assert validate_solver.check_trends(res) == VD.size - 1
    res["out"] = {"thrust": (1e-5 * VD * 5e-6 / MD).ravel()}
    with pytest.raises(AssertionError, match="mass flow"):
        validate_solver.check_trends(res)
