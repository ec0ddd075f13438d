"""Port against the JAX package: the pem_v0 UQ scripts
(``hallthrusterpem_tpu_torch/scripts/pem_v0/``: ``dataset_util``, ``mcmc``,
``monte_carlo``, ``sobol``) and the exported r5 posterior predictive.

On the r5 campaign's trained surrogate (``runs/r5/surr``, loaded by both
packages): the device posterior and the host posterior at 16 fixed thetas with
M = 1 and the QoIs V_cc, T, I_d, u_ion and j_ion, held to JAX's
``build_device_posterior`` and ``build_numpy_posterior`` within 1e-5 of each
value (float32 surrogates and float32 reconstructions on both sides: the
measured gap is ~5e-7); the surrogate column of ``run_experimental_comparison``
at the r5 posterior draws, with the nuisance input fixed from numpy: medians
within 1e-5 relative, rel-L2 within the 4 digits JAX prints. Each torch-side
``main`` runs end to end with ``--device cpu``. The port's
``data/r5_posterior_predictive.npz`` equals its regeneration from
``runs/r5/mcmc/chain_thin10.h5`` and ``runs/r5/mc/solver_verified.txt`` through
the JAX package.

Regenerate the export with ``python tests/test_torch_uq_scripts.py``.
"""

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "tests", ROOT / "scripts" / "pem_v0"):
    sys.path.insert(0, str(_p))

import dataset_util as jdu  # noqa: E402  (the JAX package's script modules)
import mcmc as jmcmc  # noqa: E402
import monte_carlo as jmc  # noqa: E402

from hallthrusterpem_tpu.core import yaml_loader as jyaml  # noqa: E402
from hallthrusterpem_tpu.uq import read_mcmc_chain  # noqa: E402
from hallthrusterpem_tpu_torch.core.json_loader import load_state, load_system  # noqa: E402
from hallthrusterpem_tpu_torch import data as tdata  # noqa: E402
from hallthrusterpem_tpu_torch.scripts.pem_v0 import dataset_util as tdu  # noqa: E402
from hallthrusterpem_tpu_torch.scripts.pem_v0 import mcmc as tmcmc  # noqa: E402
from hallthrusterpem_tpu_torch.scripts.pem_v0 import monte_carlo as tmc  # noqa: E402
from hallthrusterpem_tpu_torch.scripts.pem_v0 import sobol as tsobol  # noqa: E402
from hallthrusterpem_tpu_torch.scripts import continue_mcmc as tcontinue  # noqa: E402
from hallthrusterpem_tpu_torch.scripts import run_mcmc as trun_mcmc  # noqa: E402
from hallthrusterpem_tpu_torch.uq import read_mcmc_chain as t_read_chain  # noqa: E402
from test_torch_system import yaml_as_json_doc  # noqa: E402

torch.set_num_threads(2)
R5 = ROOT / "runs" / "r5"
EXPORT = Path(tdata.__file__).parent / "r5_posterior_predictive.npz"
QOIS = ("V_cc", "T", "I_d")
ALL_QOIS = ["V_cc", "T", "I_d", "u_ion", "j_ion"]


# ------------------------------------------------------------------ the r5 export
def _parse_solver_verified(path) -> dict:
    """Per scalar QoI of ``monte_carlo.py --compare-model``'s output: the table
    rows (V_a, mdot, P_b, data, surrogate, model) and the two rel-L2 lines."""
    tables, q = {}, None
    for line in Path(path).read_text().splitlines():
        m = re.match(r"== (\S+) \(vs data at (\d+) conditions\)", line)
        if m:
            q = m.group(1)
            tables[q] = {"n": int(m.group(2)), "rows": [], "rel_l2": {}}
            continue
        m = re.match(r"rel-L2 (surrogate|model) vs data: (\S+)$", line)
        if m and q:
            tables[q]["rel_l2"][m.group(1)] = float(m.group(2))
            continue
        toks = line.split()
        if q and len(toks) == 6 and toks[0][0].isdigit():
            tables[q]["rows"].append([float(t) for t in toks])
    return tables


def r5_export() -> dict:
    """The r5 solver-verified posterior predictive's inputs and published
    figures (``scripts/r5_followup.sh`` step 1): the 64 draws
    ``monte_carlo.py --posterior chain_thin10.h5 -n 64`` took (burn 10%, drop
    non-finite rows, flatten, ``default_rng(0).integers``), the 23 spt100
    conditions, and from ``solver_verified.txt`` the model and surrogate
    columns' per-condition medians (NaN where the QoI has no data) and rel-L2."""
    chains, _ = read_mcmc_chain(R5 / "mcmc" / "chain_thin10.h5")
    posterior = chains.reshape(-1, chains.shape[-1])
    draws = posterior[np.random.default_rng(0).integers(0, len(posterior), 64)]
    jsys = jyaml.load_system(R5 / "surr" / "pem_v0_SPT-100_trained.yml")
    names = [v.name for v in jsys.inputs() if v.category == "calibration"]
    ops, obs, _, _ = jdu.load_experiment(["spt100"], list(QOIS))
    tables = _parse_solver_verified(R5 / "mc" / "solver_verified.txt")
    out = {"draws": draws, "calib_names": np.array(names), "qois": np.array(QOIS),
           "chain_rows": np.array(len(posterior)), "duration": np.array(2e-3), **ops}
    for q in QOIS:
        idx = np.flatnonzero(np.isfinite(obs[q]))
        rows = np.asarray(tables[q]["rows"])
        assert tables[q]["n"] == len(idx) == len(rows), q
        # the printed conditions and data (4 digits) are the loader's, row for row
        for col, ref in enumerate((ops["V_a"], ops["mdot_a"], ops["P_b"], obs[q])):
            np.testing.assert_allclose(rows[:, col], ref[idx], rtol=5e-3, err_msg=q)
        out[f"data_{q}"] = obs[q]
        for col, src in ((4, "surrogate"), (5, "model")):
            med = np.full(len(obs[q]), np.nan)
            med[idx] = rows[:, col]
            out[f"{src}_median_{q}"] = med
    for src in ("surrogate", "model"):
        out[f"rel_l2_{src}"] = np.array([tables[q]["rel_l2"][src] for q in QOIS])
    return out


def test_r5_export_matches_regeneration():
    """The committed export equals its regeneration; its draws are the rows the
    port's ``posterior_draws`` takes from the same chain, and the conditions are
    the port loader's."""
    ref = r5_export()
    with np.load(EXPORT) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["draws"].shape == (64, 17) and int(got["chain_rows"]) == 115264
    np.testing.assert_array_equal(got["rel_l2_model"], [1.980e-2, 7.825e-2, 7.253e-2])
    chains, _ = read_mcmc_chain(R5 / "mcmc" / "chain_thin10.h5")
    np.testing.assert_array_equal(tmc.posterior_draws(chains.reshape(-1, 17), 64), got["draws"])
    ops, obs, _, _ = tdu.load_experiment(["spt100"], list(QOIS))
    for k in ("P_b", "V_a", "mdot_a"):
        np.testing.assert_array_equal(ops[k], got[k])
    for q in QOIS:
        np.testing.assert_array_equal(obs[q], got[f"data_{q}"])


# ------------------------------------------------------------------ r5 trained surrogate in both packages
@pytest.fixture(scope="module")
def r5_systems(tmp_path_factory):
    path = tmp_path_factory.mktemp("r5") / "pem_v0_SPT-100_trained.json"
    path.write_text(json.dumps(yaml_as_json_doc(R5 / "surr" / "pem_v0_SPT-100_trained.yml")))
    tsys = load_system(path, device="cpu")
    load_state(tsys, R5 / "surr" / "pem_v0_SPT-100_trained.yml.state.pkl")
    jsys = jyaml.load_system(R5 / "surr" / "pem_v0_SPT-100_trained.yml")
    return tsys, jsys


def _posterior_args(**kw):
    base = dict(data=["spt100"], qois=list(ALL_QOIS), noise_samples=1, field_weight=1.0, id_penalty=2.0,
                use_model=None, noise_std=0.02)
    return argparse.Namespace(**{**base, **kw})


def _thetas(calib):
    """12 draws of the r5 posterior, 3 uniform draws over the priors' middle
    60%, and one draw pushed outside its domain (T_e x 100)."""
    with np.load(EXPORT) as f:
        draws = f["draws"]
    dom = np.array([v.get_domain() for v in calib])
    mid = dom[:, 0] + np.random.default_rng(0).uniform(0.2, 0.8, (3, len(calib))) * (dom[:, 1] - dom[:, 0])
    out = draws[12:13].copy()
    out[0, 0] *= 100
    return np.concatenate([draws[:12], mid, out])


def test_posteriors_match_jax(r5_systems):
    """The port's device posterior (``build_device_posterior``: one torch
    function over the walker ensemble) and host posterior equal JAX's at 16
    thetas within 1e-5 of each value; the out-of-domain theta is -1e30 on the
    device in both."""
    tsys, jsys = r5_systems
    args = _posterior_args()
    values = {}
    for name, mod, system in (("jax", jmcmc, jsys), ("torch", tmcmc, tsys)):
        calib = [v for v in system.inputs() if v.category == "calibration"]
        names = [v.name for v in calib]
        ops, obs, sig, fields = mod.build_dataset(system, args)
        assert set(fields) == {"u_ion", "j_ion"} and len(ops["P_b"]) == 23
        dev, _ = mod.build_device_posterior(system, args, calib, names, ops, obs, sig, fields)
        host = mod.build_numpy_posterior(system, args, calib, names, ops, obs, sig, fields)
        theta = _thetas(calib)
        values[name] = (dev(theta), host(theta))
    for (ref, got), what in zip(zip(values["jax"], values["torch"]), ("device", "host")):
        assert got.shape == (16,) and got.dtype == np.float64, what
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0, err_msg=what)
    assert values["torch"][0][-1] == np.float32(-1e30) and np.all(np.abs(values["torch"][0][:15]) < 1e29)


def test_device_posterior_returns_tensor_on_device(r5_systems):
    """The function behind the numpy wrapper takes and returns tensors on the
    system's device, float32, with no TF32 left on after it."""
    tsys, _ = r5_systems
    args = _posterior_args(qois=["V_cc", "T", "I_d", "u_ion"], noise_samples=3)
    calib = [v for v in tsys.inputs() if v.category == "calibration"]
    ops, obs, sig, fields = tmcmc.build_dataset(tsys, args)
    wrapper, fn = tmcmc.build_device_posterior(tsys, args, calib, [v.name for v in calib], ops, obs, sig,
                                               fields)
    theta = _thetas(calib)[:4]
    out = fn(torch.as_tensor(theta, dtype=torch.float32))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32 and out.shape == (4,)
    np.testing.assert_array_equal(wrapper(theta), out.numpy().astype(float))
    np.testing.assert_array_equal(wrapper(theta), wrapper(theta))  # fixed common random numbers
    assert torch.get_float32_matmul_precision() == "highest" or not torch.backends.cuda.matmul.allow_tf32


def test_experimental_comparison_matches_jax(r5_systems, capsys, monkeypatch):
    """``run_experimental_comparison``'s surrogate column at the r5 posterior
    draws (both packages take the same 64 rows of the r5 chain), the nuisance
    input fixed from numpy in both: per-condition medians within 1e-5
    relative, scalar and field rel-L2 within the 4 digits JAX prints."""
    tsys, jsys = r5_systems
    chains, _ = read_mcmc_chain(R5 / "mcmc" / "chain_thin10.h5")
    posterior = chains.reshape(-1, chains.shape[-1])
    calib_names = [v.name for v in jsys.inputs() if v.category == "calibration"]
    args = argparse.Namespace(data=["spt100"], qois=ALL_QOIS, num_samples=64, compare_model=False,
                              plots=False)
    n = 64 * 23
    rng = np.random.default_rng(11)
    fixed = {v.name: rng.uniform(*v.get_domain(), n) for v in jsys.inputs()}
    captured = {}
    predict = jsys.predict
    monkeypatch.setattr(jsys, "sample_inputs", lambda *a, **k: dict(fixed))
    monkeypatch.setattr(jsys, "predict", lambda *a, **k: captured.setdefault("out", predict(*a, **k)))
    as_f32 = {n: torch.as_tensor(v, dtype=torch.float32) for n, v in fixed.items()}
    monkeypatch.setattr(tsys, "sample_inputs", lambda *a, **k: dict(as_f32))
    capsys.readouterr()
    jmc.run_experimental_comparison(jsys, args, posterior, calib_names)
    printed = capsys.readouterr().out
    res = tmc.run_experimental_comparison(tsys, args, posterior, calib_names)
    ported = capsys.readouterr().out
    for q in QOIS:
        ref = np.nanmedian(np.asarray(captured["out"][q], dtype=float).reshape(64, 23), axis=0)
        np.testing.assert_allclose(res["median"][q]["surrogate"], ref, rtol=1e-5, err_msg=q)
    pattern = r"rel-L2 surrogate vs data(?: \(mean over conditions\))?: (\S+)"
    ref_l2 = [float(x) for x in re.findall(pattern, printed)]
    got_l2 = [res["rel_l2"][q]["surrogate"] for q in QOIS] + \
             [float(np.mean(res["field_rel_l2"][q]["surrogate"])) for q in ("u_ion", "j_ion")]
    assert len(ref_l2) == 5
    np.testing.assert_allclose(got_l2, ref_l2, rtol=6e-4)
    assert ported.count("rel-L2 surrogate vs data") == 5


def test_dataset_util_matches_jax(r5_systems):
    """``load_experiment`` (every QoI) and ``field_profiles`` (the same SVD
    latents of the r5 surrogate, reconstructed by each package's compression
    map) equal JAX's; profiles within 1e-6 of their scale (float32
    reconstructions on both sides)."""
    tsys, jsys = r5_systems
    ref, got = jdu.load_experiment(["spt100"], ALL_QOIS), tdu.load_experiment(["spt100"], ALL_QOIS)
    for a, b in zip(ref[:3], got[:3]):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for q in ("u_ion", "j_ion"):
        for sa, sb in zip(ref[3][q], got[3][q]):
            assert (sa is None) == (sb is None)
            for k in (sa or {}):
                np.testing.assert_array_equal(sa[k], sb[k])
    x = {v.name: np.random.default_rng(1).uniform(*v.get_domain(), 32) for v in jsys.inputs()}
    jp = jsys.predict(x, qoi_ind=ALL_QOIS)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}  # the same latents
    for q in ("u_ion", "j_ion"):
        (pa, ga), (pb, gb) = jdu.field_profiles(jsys, jp, q), tdu.field_profiles(tsys, tp, q)
        np.testing.assert_array_equal(ga, gb)
        assert np.max(np.abs(pa - pb)) <= 1e-6 * np.max(np.abs(pa)), q
    assert tdu.resolve_data_files(["spt100"])[0].parent.parent.name == "data"
    assert tdu.resolve_data_files(["a.csv"]) == ["a.csv"]


# ------------------------------------------------------------------ the torch-side mains
@pytest.fixture()
def fake_json(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "fake_pem.json"
    path.write_text(json.dumps(yaml_as_json_doc(ROOT / "tests" / "fake_pem.yml")))
    return str(path)


MAINS = {
    "mcmc-dram-laplace-synthetic": ["mcmc", "--niter", "20", "--walkers", "4", "--use-model", "best",
                                    "--file", "chain.npz", "--qois", "V_cc", "T", "I_d", "--laplace"],
    "mcmc-stretch-fields-noise": ["mcmc", "--use-model", "best", "--data", "spt100", "--niter", "5",
                                  "--walkers", "3", "--noise-samples", "2", "--sampler", "stretch",
                                  "--qois", "V_cc", "T", "I_d", "u_ion", "j_ion", "--file", "chain.npz"],
    "monte_carlo-sweep": ["monte_carlo", "-n", "32", "--pressures", "1e-5", "3e-5",
                          "--qois", "V_cc", "T", "I_d", "--out", "mc.npz"],
    "monte_carlo-data": ["monte_carlo", "--data", "spt100", "-n", "8", "--compare-model",
                         "--allocation", "--qois", "V_cc", "T", "I_d", "u_ion"],
    "monte_carlo-data-plots": ["monte_carlo", "--data", "spt100", "-n", "8", "--plots",
                               "--qois", "V_cc", "T", "I_d", "u_ion", "j_ion"],
    "sobol": ["sobol", "-n", "64", "--pressures", "1e-5", "--qois", "T", "I_d", "V_cc", "--out", "s.json"],
}


@pytest.mark.parametrize("case", list(MAINS))
def test_main_runs_on_fake_pem(fake_json, tmp_path, case, capsys):
    mod = {"mcmc": tmcmc, "monte_carlo": tmc, "sobol": tsobol}[MAINS[case][0]]
    mod.main([fake_json, *MAINS[case][1:], "--device", "cpu"])
    out = capsys.readouterr().out
    if case.startswith("mcmc"):
        samples, logps = t_read_chain(tmp_path / "chain.npz", burn_frac=0.0, clean=False)
        n = 21 if "dram" in case else 6
        assert samples.shape[0] == n and np.isfinite(samples).all() and logps.max() > -1e29
        assert "posterior mean" in out and "host path" not in out
        assert "saved mcmc_corner.png" in out and "saved mcmc_predictive.png" in out
        assert (tmp_path / "mcmc_corner.png").exists() and (tmp_path / "mcmc_predictive.png").exists()
    elif case == "monte_carlo-sweep":
        with np.load(tmp_path / "mc.npz") as f:
            assert len(f.files) == 6 and f["P_b_1.00e-05/T"].shape == (32,)
    elif case == "monte_carlo-data-plots":
        names = ["mc_V_cc_prior.png", "mc_T_prior.png", "mc_I_d_prior.png", "mc_u_ion_prior.png",
                 "mc_j_ion_prior.png", "mc_surrogate_slices.png"]
        assert f"saved figures: {', '.join(names)}" in out
        assert all((tmp_path / n).exists() for n in names)
    elif case == "monte_carlo-data":
        assert "rel-L2 surrogate vs data" in out and "rel-L2 model vs data" in out
        assert "u_ion (field, vs data)" in out and "MISC allocation" in out
    else:
        art = json.loads((tmp_path / "s.json").read_text())
        assert art[0]["qois"] == ["T", "I_d", "V_cc"] and np.shape(art[0]["S1"]) == (12, 3)


def test_mcmc_main_device_posterior_r5(r5_systems, tmp_path, monkeypatch, capsys):
    """``mcmc.main`` on the r5 trained surrogate saved by the port (JSON +
    sidecar): the device posterior drives the stretch sampler, every call on a
    whole half-ensemble, never the per-walker fallback; then ``monte_carlo.main``
    reads the chain back."""
    tsys, _ = r5_systems
    monkeypatch.chdir(tmp_path)
    path = tsys.save_to_file("r5_trained.json", tmp_path)
    sizes = []
    real = tmcmc.build_device_posterior

    def counting(*a, **k):
        wrapper, fn = real(*a, **k)
        return (lambda theta: (sizes.append(np.shape(theta)[0]), wrapper(theta))[1]), fn

    monkeypatch.setattr(tmcmc, "build_device_posterior", counting)
    tmcmc.main([str(path), "--data", "spt100", "--qois", "V_cc", "T", "I_d", "u_ion", "j_ion",
                "--sampler", "stretch", "--walkers", "34", "--niter", "3", "--file", "chain.npz",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "one PyTorch function over the walker ensemble on cpu" in out
    assert sizes == [34] + [17] * 6
    res = tmc.main([str(path), "--data", "spt100", "-n", "4", "--posterior", "chain.npz", "--device", "cpu",
                    "--qois", "V_cc", "T", "I_d"])
    assert set(res["rel_l2"]) == set(QOIS) and "posterior predictive from" in capsys.readouterr().out


def test_run_mcmc_restart(fake_json, tmp_path):
    """``run_mcmc`` runs DRAM, then restarts a second chain from the first's most
    probable sample with its scaled sample covariance."""
    real_dram = tmcmc.dram
    common = [fake_json, "--niter", "20", "--walkers", "4", "--use-model", "best", "--device", "cpu"]
    trun_mcmc.main(common + ["--file", "c1.npz"])
    c1, lp1 = t_read_chain(tmp_path / "c1.npz", burn_frac=0.5)
    flat = c1.reshape(-1, c1.shape[-1])
    x0 = flat[np.argmax(lp1.reshape(-1))]
    samples, _, _ = trun_mcmc.main(common + ["--file", "c2.npz", "--restart", "c1.npz"])
    c2, _ = t_read_chain(tmp_path / "c2.npz", burn_frac=0.0, clean=False)
    assert c2.shape == (21, 4, flat.shape[1]) and np.array_equal(c2, samples)
    # every walker starts at the restart point (DRAM jitters each by 1e-6 relative)
    np.testing.assert_allclose(c2[0], np.broadcast_to(x0, c2[0].shape), rtol=1e-5)
    assert tmcmc.dram is real_dram


def test_continue_mcmc_appends_from_last_ensemble(r5_systems, tmp_path, monkeypatch, capsys):
    """``continue_mcmc`` on a stored 6-row chain of 34 walkers on the r5 trained
    surrogate: it starts from the stored last ensemble and appends ``niter``
    ensembles, the stored rows untouched."""
    tsys, _ = r5_systems
    monkeypatch.chdir(tmp_path)
    config = tsys.save_to_file("r5_trained.json", tmp_path)
    with np.load(EXPORT) as f:
        draws = f["draws"][:34]
    rng = np.random.default_rng(5)
    stored = draws[None] * (1 + 1e-3 * rng.standard_normal((6,) + draws.shape))
    stored[-1] = draws
    np.savez(tmp_path / "chain.npz", samples=stored, log_pdf=np.zeros(stored.shape[:2]))
    samples, logps, acc = tcontinue.main(["chain.npz", "--config", str(config), "--niter", "3",
                                          "--noise-samples", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    chain, lp = t_read_chain(tmp_path / "chain.npz", burn_frac=0.0, clean=False)
    assert samples.shape == (4, 34, 17) and np.array_equal(samples[0], draws)
    assert chain.shape == (9, 34, 17)
    np.testing.assert_array_equal(chain[:6], stored)
    np.testing.assert_array_equal(chain[6:], samples[1:])
    np.testing.assert_array_equal(lp[6:], logps[1:])
    assert np.isfinite(logps).all() and 0.0 <= acc <= 1.0
    assert "continuing from ensemble state (34, 17)" in out and "honest ESS per param" in out


if __name__ == "__main__":
    arrays = r5_export()
    with open(EXPORT, "wb") as fd:
        np.savez(fd, **arrays)
    print(f"wrote {EXPORT} ({EXPORT.stat().st_size} bytes)")
