"""Port against the JAX package: solver configuration, rate fits, device data.

Numbers that both packages compute in float64 numpy must agree exactly (or to
1e-12 where a float64 expression is formed in another order); the B-field is
interpolated in float32 by both and must agree to one float32 rounding."""

import numpy as np
import pytest
import torch

from hallthrusterpem_tpu.models.thruster import _load_bfield as jax_load_bfield
from hallthrusterpem_tpu.models.thruster import config as jcfg
from hallthrusterpem_tpu.models.thruster import rates as jrates
from hallthrusterpem_tpu.models.thruster.mapping import default_model_fidelity as jax_fidelity
from hallthrusterpem_tpu.utils import load_thruster as jax_load_thruster
from hallthrusterpem_tpu_torch.models.thruster import _load_bfield
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.models.thruster import rates as trates
from hallthrusterpem_tpu_torch.models.thruster.mapping import default_model_fidelity
from hallthrusterpem_tpu_torch.utils import load_thruster


@pytest.mark.parametrize("fidelity", [(0, 0), (1, 1), (2, 2)])
def test_solver_config_matches(fidelity):
    fj = jax_fidelity(fidelity, {"config": {}})
    ft = default_model_fidelity(fidelity, {"config": {}})
    assert fj == ft
    kw = dict(num_cells=ft["num_cells"], ncharge=ft["ncharge"], dt=ft["dt"],
              duration=5e-4, average_start_time=2.5e-4, solve_plume=True)
    cj, ct = jcfg.SolverConfig(**kw), tcfg.SolverConfig(**kw)
    for attr in ("nc", "dz", "dt", "num_steps", "avg_start_step", "mi"):
        assert getattr(cj, attr) == getattr(ct, attr), attr
    assert cj.geometry.channel_area == ct.geometry.channel_area
    np.testing.assert_array_equal(cj.cell_centers(), ct.cell_centers())


def test_bench_config_step_counts():
    """The fidelity (2,2) bench run: 202 cells, 3 charge states, 228,451 steps."""
    f = default_model_fidelity((2, 2), {"config": {}})
    cfg = tcfg.SolverConfig(num_cells=f["num_cells"], ncharge=f["ncharge"], dt=f["dt"],
                            duration=5e-4, average_start_time=2.5e-4)
    assert (cfg.nc, cfg.ncharge, cfg.num_steps, cfg.avg_start_step) == (202, 3, 228451, 114225)


@pytest.mark.parametrize("ncharge", [1, 2, 3])
def test_rate_log_polys_match(ncharge):
    rj = jrates.build_reactions("Xenon", ncharge)
    rt = trates.build_reactions("Xenon", ncharge)
    assert [(r.z_from, r.z_to, r.energy_eV) for r in rj] == [(r.z_from, r.z_to, r.energy_eV) for r in rt]
    for a, b in zip(rj, rt):
        np.testing.assert_allclose(b.log_poly, a.log_poly, rtol=1e-12, atol=0)
        np.testing.assert_allclose(trates.dlnk_dlnTe_poly(b.log_poly),
                                   jrates.dlnk_dlnTe_poly(a.log_poly), rtol=1e-12, atol=0)
    ej, Ej = jrates.excitation_log_poly("Xenon")
    et, Et = trates.excitation_log_poly("Xenon")
    assert Ej == Et
    np.testing.assert_allclose(et, ej, rtol=1e-12, atol=0)
    assert trates.K_EN == jrates.K_EN


def test_device_json_matches_yaml():
    dj = jax_load_thruster("SPT-100")
    dt = load_thruster("SPT-100")
    assert dt["name"] == dj["name"]
    assert dt["geometry"] == dj["geometry"]
    fj, ft = dj["magnetic_field"]["file"], dt["magnetic_field"]["file"]
    assert fj.rsplit("/", 1)[-1] == ft.rsplit("/", 1)[-1]
    np.testing.assert_array_equal(np.genfromtxt(ft, delimiter=",", skip_header=1),
                                  np.genfromtxt(fj, delimiter=",", skip_header=1))


@pytest.mark.parametrize("num_cells", [60, 200])
def test_bfield_matches(num_cells):
    kw = dict(num_cells=num_cells, ncharge=1)
    bj = np.asarray(jax_load_bfield(jax_load_thruster("SPT-100"), jcfg.SolverConfig(**kw)))
    bt = _load_bfield(load_thruster("SPT-100"), tcfg.SolverConfig(**kw))
    assert bt.dtype == np.float32 and bt.shape == bj.shape == (num_cells + 2,)
    np.testing.assert_allclose(bt, bj, rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("field", [{"file": "no_such_bfield.csv"}, {"file": "missing_dir/bfield.csv"}])
def test_bfield_without_file_raises(field):
    """The port never invents a field for a device whose named field file is missing."""
    with pytest.raises(FileNotFoundError):
        _load_bfield({"magnetic_field": field}, tcfg.SolverConfig(num_cells=60, ncharge=1))


@pytest.mark.parametrize("thr", [{}, {"magnetic_field": {}}, {"geometry": {"channel_length": 0.03}}])
@pytest.mark.parametrize("num_cells", [60, 200])
def test_bfield_default_profile_matches(thr, num_cells):
    """A device that names no field file gets the JAX package's default profile."""
    geom = thr.get("geometry", {})
    kw = dict(num_cells=num_cells, ncharge=1)
    cj = jcfg.SolverConfig(**kw, geometry=jcfg.Geometry(**geom))
    ct = tcfg.SolverConfig(**kw, geometry=tcfg.Geometry(**geom))
    bt = _load_bfield(thr, ct)
    assert bt.dtype == np.float32 and bt.shape == (num_cells + 2,)
    np.testing.assert_array_equal(bt, np.asarray(jax_load_bfield(thr, cj), np.float32))


def test_make_params_and_ingestion_flux_match():
    rng = np.random.default_rng(1)
    over = {"V_d": rng.uniform(250, 350, 6).astype(np.float32),
            "P_b": rng.uniform(0, 5e-5, 6).astype(np.float32), "f_n": 1.3}
    pj = jcfg.make_params(over)
    pt = tcfg.make_params({k: torch.as_tensor(v) for k, v in over.items()}, device="cpu")
    assert set(pj) == set(pt)
    for k in pj:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    cfg_j, cfg_t = jcfg.SolverConfig(), tcfg.SolverConfig()
    fj = np.asarray(jcfg.background_neutral_ingestion_flux(pj["P_b"], pj["f_n"], cfg_j))
    ft = tcfg.background_neutral_ingestion_flux(pt["P_b"], pt["f_n"], cfg_t).numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-6)
