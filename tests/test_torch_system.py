"""Port against the JAX package: the System layer (variables, components,
systems, JSON configuration files), the packaged configurations and the H9
device.

The shapes of tests/test_system.py run on a JSON copy of tests/fake_pem.yml,
converted here from the YAML as the JAX loader reads it. Draws come from
seeded ``torch.Generator``s: JAX's random streams are not reproducible in torch,
so sampled values are checked by their semantics, and the real-model prediction
takes the same numpy inputs in both packages. Tolerances: configurations,
devices and B-field profiles equal exactly; the real-model prediction masks the
same rows and its unguarded T, I_d and I_B0 agree within 1%, the run-level bound
of tests/test_pallas.py."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from hallthrusterpem_tpu.core import yaml_loader as jyaml
from hallthrusterpem_tpu.models.thruster import _load_bfield as jax_load_bfield
from hallthrusterpem_tpu.models.thruster import config as jcfg
from hallthrusterpem_tpu.ops.svd import svd_rank as jax_svd_rank
from hallthrusterpem_tpu.utils import load_thruster as jax_load_thruster
from hallthrusterpem_tpu_torch.core import Component, System, Variable
from hallthrusterpem_tpu_torch.core.component import resolve_model
from hallthrusterpem_tpu_torch.core.json_loader import config_dir, find_latest_save, load_system, save_system
from hallthrusterpem_tpu_torch.core.variables import parse_distribution, parse_norms
from hallthrusterpem_tpu_torch.models.thruster import _load_bfield
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.ops.svd import svd_rank
from hallthrusterpem_tpu_torch.utils import load_thruster

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {
    "pem_v0_SPT-100.json": ROOT / "scripts" / "pem_v0" / "pem_v0_SPT-100.yml",
    "pem_v0_H9.json": ROOT / "scripts" / "pem_v0" / "pem_v0_H9.yml",
    "pem_v1_SPT-100.json": ROOT / "scripts" / "pem_v1" / "pem_v1_SPT-100.yml",
}


def yaml_as_json_doc(path) -> dict:
    """A System YAML file as the JAX loader reads it, its tags dropped: the
    document the port's JSON copy holds (``!!python/name:`` paths as strings)."""
    with open(path, encoding="utf-8") as fd:
        raw = yaml.load(fd, Loader=jyaml._PemLoader)

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()
                    if k not in ("__system__", "__component__", "__variable__")}
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    return strip(raw)


@pytest.fixture()
def fake_system(tmp_path):
    path = tmp_path / "fake_pem.json"
    path.write_text(json.dumps(yaml_as_json_doc(ROOT / "tests" / "fake_pem.yml")))
    return load_system(path, device="cpu")


# every distribution kind and every norm kind, with and without a nominal, a
# chained norm, a domain without a distribution, and a variable with neither
VARIABLE_SPECS = {
    "uniform-log10": dict(distribution="U(1, 5)", norm="log10"),
    "loguniform-log": dict(distribution="LogUniform(0.00316, 0.1)", norm="log"),
    "normal-zscore": dict(distribution="N(0.2, 0.07)", norm="zscore(0.2, 0.07)"),
    "relative-minmax": dict(distribution="Relative(20)", nominal=10.0, norm="minmax(8, 12)"),
    "relative-negative-nominal": dict(distribution="Rel(5)", nominal=-3.0, norm="none"),
    "tolerance-linear-offset": dict(distribution="Tolerance(1)", nominal=10.0, norm="linear(1e6, 3)"),
    "uniform-linear-log10-chain": dict(distribution="Uniform(10e-6, 100e-6)", norm="linear(1e6); log10"),
    "domain-only": dict(domain="(2, 7)", nominal=5.0, norm="linear(0.5)"),
    "free": dict(nominal=1.0),
}


@pytest.mark.parametrize("case", sorted(VARIABLE_SPECS))
def test_variable_matches_jax(case):
    """The port's ``Variable`` against JAX's from the same spec: domain,
    normalize, denormalize and pdf on the same float64 inputs, as numpy arrays
    and as torch tensors, spanning 20% past each side of the domain; within
    1e-12 of each value (float64; torch and numpy may round a transcendental
    differently in the last place)."""
    from hallthrusterpem_tpu.core.variables import Variable as JaxVariable

    spec = dict(VARIABLE_SPECS[case], name="x")
    jv, tv = JaxVariable(**spec), Variable(**spec)
    assert tv.get_domain() == jv.get_domain()
    lo, hi = jv.get_domain() or (0.5, 2.0)
    rng = np.random.default_rng(21)
    x = rng.uniform(lo - 0.2 * abs(lo), hi + 0.2 * abs(hi), 257)
    x[:4] = [lo, hi, lo - 0.1 * abs(lo), hi + 0.1 * abs(hi)]
    y = np.asarray(jv.normalize(x))
    tight = dict(rtol=1e-12, atol=0)
    for name, ref, call in (("normalize", y, lambda v: v.normalize),
                            ("denormalize", np.asarray(jv.denormalize(y)), lambda v: v.denormalize),
                            ("normalize(denorm=True)", np.asarray(jv.normalize(y, denorm=True)),
                             lambda v: lambda a: v.normalize(a, denorm=True)),
                            ("pdf", np.asarray(jv.pdf(x)), lambda v: v.pdf)):
        arg = x if name in ("normalize", "pdf") else y
        np.testing.assert_allclose(np.asarray(call(tv)(arg)), ref, err_msg=name, **tight)
        got = call(tv)(torch.as_tensor(arg))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64, name
        np.testing.assert_allclose(got.numpy(), ref, err_msg=name, **tight)
    if jv.distribution is not None:
        d_j, d_t = jv.distribution, tv.distribution
        assert (d_t.kind, d_t.params) == (d_j.kind, d_j.params)
        assert d_t.bounds(spec.get("nominal")) == d_j.bounds(spec.get("nominal"))
        for nom in {spec.get("nominal"), 4.0} - {None}:
            np.testing.assert_allclose(np.asarray(d_t.pdf(x, nominal=nom)),
                                       np.asarray(d_j.pdf(x, nominal=nom)), **tight)


def test_variable_dsl():
    v = Variable(name="x", distribution="U(1, 5)", norm="log10", nominal=2.0)
    assert v.distribution.kind == "uniform"
    assert np.isclose(float(v.normalize(100.0)), 2.0)
    assert np.isclose(float(v.denormalize(2.0)), 100.0)
    assert torch.isclose(v.denormalize(torch.tensor(2.0)), torch.tensor(100.0))
    v2 = Variable(name="y", distribution="Relative(20)", nominal=10.0)
    lo, hi = v2.get_domain()
    assert np.isclose(lo, 8.0) and np.isclose(hi, 12.0)
    v3 = Variable(name="z", distribution="N(0.2, 0.07)")
    assert np.isclose(v3.distribution.mu, 0.2)
    assert float(v3.pdf(0.2)) > float(v3.pdf(0.5))
    assert float(v3.pdf(torch.tensor(0.2))) == pytest.approx(float(v3.pdf(0.2)), rel=1e-6)
    norms = parse_norms("linear(1e6)")
    assert np.isclose(float(norms[0].forward(2e-6)), 2.0)
    assert parse_distribution("LogUniform(0.00316, 0.1)").kind == "loguniform"
    with pytest.raises(ValueError):
        parse_distribution("Cauchy(0, 1)")


@pytest.mark.parametrize("spec,lo,hi", [("U(1, 5)", 1, 5), ("LogUniform(0.001, 0.1)", 0.001, 0.1),
                                        ("N(3, 0.1)", 2, 4), ("Relative(20)", 8, 12), ("Tolerance(1)", 9, 11)])
def test_distribution_draws(spec, lo, hi):
    """Draws from an explicit generator: float32 CPU tensors inside the support,
    the same for the same seed; a per-sample nominal centres each draw."""
    d = parse_distribution(spec)
    x = d.sample(torch.Generator().manual_seed(4), (2000,), nominal=10.0)
    assert x.dtype == torch.float32 and x.shape == (2000,)
    assert float(x.min()) >= lo * (1 - 1e-6) and float(x.max()) <= hi * (1 + 1e-6)
    assert torch.equal(x, d.sample(torch.Generator().manual_seed(4), (2000,), nominal=10.0))
    if d.kind in ("relative", "tolerance"):
        per = d.sample(torch.Generator().manual_seed(5), (2,), nominal=torch.tensor([10.0, 1000.0]))
        assert 900 < float(per[1]) < 1100 and float(per[0]) < 12


def test_json_load_structure(fake_system):
    s = fake_system
    assert s.name == "fake-pem" and s.device.type == "cpu"
    assert [c.name for c in s.components] == ["Cathode", "Thruster", "Plume"]
    in_names = [v.name for v in s.inputs()]
    assert "P_b" in in_names and "V_cc" not in in_names and "I_B0" not in in_names
    assert {"V_cc", "T", "I_d", "j_ion"} <= {v.name for v in s.outputs()}
    # a bare `{name: P_b}` in Plume takes the full Cathode definition
    assert s["Plume"]["P_b"].distribution is not None
    assert {v.name for v in s.coupling_vars} == {"V_cc", "I_B0"}
    assert s.graph.nodes["Cathode"]["exo_in"] == [in_names.index(n) for n in
                                                  ["P_b", "V_a", "T_e", "V_vac", "Pstar", "P_T"]]
    assert ("Thruster", "Plume") in s.graph.edges
    assert s["Plume"].model_kwargs["sweep_radius"] == 1.0


def test_sample_inputs_semantics(fake_system):
    s = fake_system
    samples = s.sample_inputs(64, seed=0, use_pdf=["calibration", "nuisance"])
    assert set(samples) == {v.name for v in s.inputs()}
    for arr in samples.values():
        assert arr.shape == (64,) and arr.dtype == torch.float32
    # operating variables draw uniformly over their domain
    assert torch.all((samples["V_a"] >= 200) & (samples["V_a"] <= 400))
    s2 = s.sample_inputs(8, seed=1, constants=["calibration"], nominal={"T_e": 3.3})
    assert torch.allclose(s2["T_e"], torch.tensor(3.3))
    s3 = s.sample_inputs(128, generator=torch.Generator().manual_seed(2), normalize=True, use_pdf=True)
    assert float(s3["Pstar"].min()) >= 8.0 and float(s3["Pstar"].max()) <= 102.0
    # the same generator state gives the same draws
    again = s.sample_inputs(64, generator=torch.Generator().manual_seed(0), use_pdf=["calibration", "nuisance"])
    assert all(torch.equal(again[k], samples[k]) for k in samples)
    # rejection against a domain filter: every returned row passes it
    kept = s.sample_inputs(32, seed=3, domain_filter=lambda d: d["V_a"] > 300)
    assert torch.all(kept["V_a"] > 300)
    with pytest.raises(RuntimeError):
        s.sample_inputs(4, seed=3, domain_filter=lambda d: d["V_a"] > 1e4, max_rejection_rounds=3)


def test_predict_feed_forward(fake_system):
    s = fake_system
    samples = s.sample_inputs(32, seed=0, use_pdf=["calibration", "nuisance"])
    out = s.predict(samples, use_model="best")
    assert out["V_cc"].shape == (32,) and out["T"].shape == (32,)
    assert out["j_ion"].shape == (32, 91) and out["u_ion"].shape == (32, 100)
    assert torch.all(out["T"] > 0) and torch.isfinite(out["j_ion"]).all()
    out2 = s.predict(samples, use_model="best", qoi_ind=["T", "j_ion"])
    assert set(out2) == {"T", "j_ion", "j_ion_coords"}
    assert s["Thruster"].model_costs
    with pytest.raises(KeyError):
        s.predict({"P_b": samples["P_b"]}, use_model="best")


def test_predict_normalized_inputs(fake_system, tmp_path):
    """``predict(normalized=True)`` denormalizes each input as JAX's System
    does: on the same normalized float32 inputs both fake systems give the same
    outputs within 1e-5 of each output's scale (float32)."""
    s = fake_system
    samples_n = s.sample_inputs(16, seed=3, normalize=True, use_pdf=True)
    out = s.predict(samples_n, use_model="best", normalized=True)
    assert torch.all(out["T"] > 0)
    yml = tmp_path / "fake_pem.yml"
    yml.write_text((ROOT / "tests" / "fake_pem.yml").read_text())
    ref = jyaml.load_system(yml).predict({k: v.numpy() for k, v in samples_n.items()},
                                         use_model="best", normalized=True)
    assert set(ref) == set(out)
    for key, r in ref.items():
        r, g = np.asarray(r, np.float64), out[key].double().numpy()
        assert g.shape == r.shape, key
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.max(np.abs(r)), err_msg=key)


def test_save_load_roundtrip(fake_system, tmp_path):
    s = fake_system
    s.predict(s.sample_inputs(4, seed=0), use_model="best")
    comp = s["Thruster"]["u_ion"].compression
    comp.compute_map(np.random.default_rng(0).standard_normal((100, 12)))
    path = s.save_to_file("saved.json", save_dir=tmp_path)
    s2 = System.load_from_file(path, device="cpu")
    assert s2.name == s.name
    assert [c.name for c in s2.components] == [c.name for c in s.components]
    assert s2["Cathode"]["P_b"].distribution.kind == "relative"
    assert s2["Plume"].model_kwargs["sweep_radius"] == 1.0
    assert s2["Thruster"].model_costs == s["Thruster"].model_costs
    np.testing.assert_array_equal(s2["Thruster"]["u_ion"].compression.projection, comp.projection)
    assert find_latest_save(tmp_path) == tmp_path
    out = s2.predict(s2.sample_inputs(4, seed=5), use_model="best")
    assert out["T"].shape == (4,)
    # the saved document is what the loader reads back
    assert json.loads(path.read_text())["components"][1]["model"].endswith("fake_thruster")
    assert save_system(s2, tmp_path / "run_iter1.json") == tmp_path / "run_iter1.json"
    assert find_latest_save(tmp_path) == tmp_path / "run_iter1.json"


def test_load_system_paths(tmp_path, monkeypatch):
    """A bare name falls back to the packaged configurations, which get no
    ``root_dir``; a path with a directory part must exist, as in JAX's loader."""
    monkeypatch.chdir(tmp_path)
    packaged = load_system("pem_v0_SPT-100.json", device="cpu")
    assert packaged.root_dir is None
    with pytest.raises(FileNotFoundError):
        load_system(tmp_path / "typo_dir" / "pem_v0_SPT-100.json", device="cpu")
    with pytest.raises(FileNotFoundError):
        load_system("no_such_config.json", device="cpu")
    local = tmp_path / "pem_v0_SPT-100.json"
    local.write_text((config_dir() / "pem_v0_SPT-100.json").read_text())
    assert load_system("pem_v0_SPT-100.json", device="cpu").root_dir == Path(".")
    assert load_system(local, device="cpu").root_dir == tmp_path
    path = packaged.save_to_file("saved.json")
    assert path == Path("saved.json") and (tmp_path / "saved.json").exists()


def test_component_get_cost_and_unported_methods(fake_system, tmp_path):
    """Costs recorded by ``call_model``; the surrogate side (A9) answers: the
    allocation counts the evaluations, ``as_jax_fn`` needs trained surrogates, a
    missing training cache is not found; the plots draw through ``viz``."""
    s = fake_system
    s.predict(s.sample_inputs(8, seed=0), use_model="best")
    comp = s["Thruster"]
    assert comp.get_cost(comp.model_fidelity) > 0
    cost_alloc, model_cost, overhead, evals = s.get_allocation()
    assert evals["Thruster"][comp.model_fidelity] == 8 and model_cost > 0 and overhead == 0.0
    with pytest.raises(ValueError, match="no trained surrogate"):
        s.as_jax_fn()
    with pytest.raises(FileNotFoundError):
        s.load_training_cache(tmp_path / "cache.pkl")
    fig, ax = s.plot_allocation()
    assert [t.get_text() for t in ax.get_yticklabels()] == [f"{c.name} a={c.model_fidelity}" for c in s.components]
    fig, axes = s.plot_slice(inputs=["P_b"], outputs=["T"], num_steps=3)
    assert axes.shape == (1, 1) and len(axes[0][0].lines[0].get_ydata()) == 3


def test_compression_and_svd_rank_match_jax():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((40, 5)) @ rng.standard_normal((5, 30)) + 1e-3 * rng.standard_normal((40, 30))
    A[:, 3] = np.nan
    for kw in ({}, {"rank": 3}, {"energy_tol": 0.99}, {"reconstruction_tol": 1e-4}):
        (Uj, rj), (Ut, rt) = jax_svd_rank(A, **kw), svd_rank(A, **kw)
        assert rt == rj
        np.testing.assert_array_equal(Ut, Uj)
    var = Variable.from_dict({"name": "f", "compression": {"method": "svd", "reconstruction_tol": 0.01}})
    var.compression.compute_map(np.nan_to_num(A))
    x = torch.as_tensor(A[:, :2].T.copy()).nan_to_num()
    lat = var.compression.compress(x)
    assert lat.shape == (2, var.compression.latent_size)
    np.testing.assert_allclose(var.compression.reconstruct(lat).numpy(),
                               var.compression.reconstruct(var.compression.compress(x.numpy())), rtol=1e-12)


def test_dataset_helpers_match_jax():
    from hallthrusterpem_tpu.core import dataset as jds
    from hallthrusterpem_tpu.core.variables import Variable as JaxVariable
    from hallthrusterpem_tpu_torch.core import dataset as tds

    x = {"a": np.arange(4.0), "b": np.linspace(1, 2, 4), "u_coords": np.zeros((4, 3))}
    stacked = tds.stack_dataset({k: torch.as_tensor(v) for k, v in x.items()}, ["a", "b"])
    np.testing.assert_allclose(stacked.numpy(), np.asarray(jds.stack_dataset(x, ["a", "b"])), rtol=1e-7)
    back = tds.unstack_dataset(stacked, ["a", "b"])
    assert set(back) == {"a", "b"} and np.array_equal(back["b"].numpy(), x["b"])
    assert tds.dataset_shape(x) == jds.dataset_shape(x) == (4,)
    assert tds.is_coords_key("u_coords") and tds.base_var_of_coords("u_coords") == "u"
    spec = {"name": "a", "norm": "log10"}
    norm = {"a": np.array([0.0, 1.0, 2.0]), "extra": np.array([5.0])}
    got, got_extra = tds.to_model_dataset({k: torch.as_tensor(v) for k, v in norm.items()}, [Variable(**spec)])
    ref, ref_extra = jds.to_model_dataset(norm, [JaxVariable(**spec)])
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(ref["a"]), rtol=1e-12)
    assert set(got_extra) == set(ref_extra) == {"extra"}
    assert tds.as_numpy(got)["a"].dtype == np.float64


def test_resolve_model_maps_paths_to_the_port():
    from hallthrusterpem_tpu_torch.models import cathode, fake_thruster, plume
    from hallthrusterpem_tpu_torch.models import thruster

    assert resolve_model("hallmd.models.cathode.cathode_coupling") is cathode.cathode_coupling
    assert resolve_model("hallthrusterpem_tpu.models.thruster.hallthruster_jl") is thruster.hallthruster_jl
    assert resolve_model("hallthrusterpem_tpu.models.plume.current_density") is plume.current_density
    assert resolve_model("hallthrusterpem_tpu_torch.models.fake_thruster.fake_thruster") is fake_thruster.fake_thruster
    assert Component(name="c", model=len).fn is len


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_committed_configs_match_yaml(name):
    """Each packaged JSON copy equals its YAML as the JAX loader reads it, and
    loads into a System with the JAX System's components and variables."""
    doc = json.loads((config_dir() / name).read_text())
    assert doc == yaml_as_json_doc(CONFIGS[name])
    jsys = jyaml.load_system(CONFIGS[name])
    tsys = load_system(name, device="cpu")
    assert [c.name for c in tsys.components] == [c.name for c in jsys.components]
    for tc, jc in zip(tsys.components, jsys.components):
        assert tc.model_kwargs == jc.model_kwargs and tc.model_fidelity == jc.model_fidelity
        assert tc.fn.__module__.startswith("hallthrusterpem_tpu_torch.")
        spec = lambda v: (v.name, v.nominal, v.domain, [(n.kind, n.params) for n in v.norm],
                          v.distribution and (v.distribution.kind, v.distribution.params))
        assert [spec(v) for v in tc.inputs + tc.outputs] == [spec(v) for v in jc.inputs + jc.outputs]
    assert [v.name for v in tsys.inputs()] == [v.name for v in jsys.inputs()]


def test_compression_config_matches_r5():
    """``configs/pem_v0_SPT-100_compression.json`` is the r5 campaign's
    ``pem_v0_SPT-100_compression.yml`` with its state's compression maps (u_ion
    rank 20, j_ion rank 6), as the JAX loader reads them: the document equal, and
    every projection, grid and rank equal."""
    r5 = ROOT / "runs" / "r5" / "surr" / "pem_v0_SPT-100_compression.yml"
    doc = json.loads((config_dir() / "pem_v0_SPT-100_compression.json").read_text())
    assert set(doc.pop("state")) == {"compression"}
    assert doc == yaml_as_json_doc(r5)
    jsys, tsys = jyaml.load_system(r5), load_system("pem_v0_SPT-100_compression.json", device="cpu")
    ranks = {}
    for jc, tc in zip(jsys.components, tsys.components):
        for jv, tv in zip(jc.outputs, tc.outputs):
            if jv.compression is None or jv.compression.projection is None:
                assert tv.compression is None or tv.compression.projection is None
                continue
            ranks[tv.name] = tv.compression.rank
            assert tv.compression.rank == jv.compression.rank == tv.compression.latent_size
            np.testing.assert_array_equal(tv.compression.projection, jv.compression.projection)
            np.testing.assert_array_equal(tv.compression.coords, jv.compression.coords)
    assert ranks == {"u_ion": 20, "j_ion": 6}


def test_h9_device_matches_jax():
    """``load_thruster("H9")`` and its B-field on a 300-cell grid equal JAX's."""
    dj, dt = jax_load_thruster("H9"), load_thruster("H9")
    assert Path(dt["magnetic_field"]["file"]).name == Path(dj["magnetic_field"]["file"]).name == "bfield_h9.csv"
    assert {k: v for k, v in dt.items() if k != "magnetic_field"} == {
        k: v for k, v in dj.items() if k != "magnetic_field"}
    np.testing.assert_array_equal(np.loadtxt(dt["magnetic_field"]["file"], delimiter=",", skiprows=1),
                                  np.loadtxt(dj["magnetic_field"]["file"], delimiter=",", skiprows=1))
    kw = dict(num_cells=300, ncharge=1, geometry=jcfg.Geometry(**dj["geometry"]))
    bj = np.asarray(jax_load_bfield(dj, jcfg.SolverConfig(**kw)), np.float32)
    bt = _load_bfield(dt, tcfg.SolverConfig(**dict(kw, geometry=tcfg.Geometry(**dt["geometry"]))))
    np.testing.assert_array_equal(bt, bj)


def _pem_v0_short(system):
    """The Thruster of a pem_v0 system cut to 60 cells and 2e-6 s (155 steps),
    its failure guards and cycle average as configured. The trace keeps 50 points:
    with more save points than steps the JAX package's two solvers disagree on the
    tail (its K-step driver records the last launch's overshoot steps, its lax
    solver leaves zeros), and the port follows each."""
    comp = system["Thruster"]
    comp.model_fidelity = ()
    sim = dict(comp.model_kwargs["simulation"], duration=2e-6, num_save=50,
               grid={"type": "EvenGrid", "num_cells": 60})
    comp.model_kwargs.update(simulation=sim, model_fidelity=None,
                             postprocess=dict(comp.model_kwargs["postprocess"], average_start_time=1e-6))
    return system


def test_predict_pem_v0_matches_jax():
    """``System.predict(use_model="best")`` on the pem_v0 SPT-100 copy (Cathode ->
    Thruster -> Plume) at 60 cells and 2e-6 s, B = 3, against the JAX System on
    the YAML with the same numpy inputs: the same rows masked, the unguarded T,
    I_d and I_B0 within 1%, and the cathode's V_cc within 1e-6."""
    jsys = _pem_v0_short(jyaml.load_system(CONFIGS["pem_v0_SPT-100.json"]))
    tsys = _pem_v0_short(load_system("pem_v0_SPT-100.json", device="cpu"))
    rng = np.random.default_rng(11)
    x = {v.name: np.float32(v.nominal) * (1 + 0.05 * rng.uniform(-1, 1, 3)).astype(np.float32)
         for v in jsys.inputs()}
    ref = jsys.predict(x, use_model="best")
    got = tsys.predict({k: torch.as_tensor(v) for k, v in x.items()}, use_model="best")
    assert set(ref) <= set(got) | {"thruster_output"} and "T" in got
    np.testing.assert_array_equal(np.isnan(got["T"].numpy()), np.isnan(np.asarray(ref["T"])))
    np.testing.assert_allclose(got["V_cc"].numpy(), np.asarray(ref["V_cc"]), rtol=1e-6)
    avg_ref = ref["thruster_output"]["output"]["average"]
    avg_got = got["thruster_output"]["output"]["average"]
    for key in ("thrust", "discharge_current", "ion_current"):
        g, r = avg_got[key].numpy(), np.asarray(avg_ref[key])
        assert np.all(np.isfinite(r)), key
        assert np.max(np.abs(g - r) / np.abs(r)) < 0.01, key
    assert got["j_ion"].shape == (3, 91) and tsys["Thruster"].model_costs
