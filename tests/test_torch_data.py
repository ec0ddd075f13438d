"""Port against the JAX package: the data loaders (``data/loader.py``, read with
``csv`` and numpy in the port, with pandas in the JAX package) and the bundled
SPT-100 datasets.

Every bundled CSV and every synthetic case of tests/test_data.py (and a few
more: the derived flow's precedence, absolute over relative uncertainty,
defaults, custom schemas, empty cells) gives EQUAL entries through both loaders:
operating conditions, values, stds, coordinates, units and order. Python's
``float`` and pandas' parser round these files' decimal strings alike, so no
1-ulp allowance is needed. The port's CSV copies are byte-equal to the JAX
package's.
"""

import numpy as np
import pytest
import torch

from hallthrusterpem_tpu import data as J
from hallthrusterpem_tpu_torch import data as T

CASES = {
    "scalar-qois-relative": (
        "Background Pressure (Torr),Anode Flow Rate (mg/s),Discharge Voltage (V),"
        "Thrust (mN),Thrust relative uncertainty,Discharge Current (A)\n"
        "1e-5,5.0,300,80,0.05,4.5\n3e-5,5.0,300,82,0.05,4.6\n"),
    "alias-flow-from-fraction": (
        "Total Flow Rate (mg/s),Cathode Flow Fraction,Anode Voltage (V),Anode Current (A)\n"
        "6.0,0.1,250,4.0\n"),
    "flow-from-ratio": (
        "Total Flow Rate (mg/s),Anode-Cathode Flow Ratio,Discharge Voltage (V)\n6.0,9.0,300\n"),
    "ratio-before-fraction": (
        "Total Flow Rate (mg/s),Cathode Flow Fraction,Anode-Cathode Flow Ratio,Discharge Voltage (V)\n"
        "6.0,0.2,9.0,300\n6.5,0.1,8.0,250\n"),
    "ion-current-density-field": (
        "Background Pressure (Torr),Anode Flow Rate (mg/s),Discharge Voltage (V),"
        "Radial Position from Thruster Exit (m),Angular Position from Thruster Centerline (deg),"
        "Ion Current Density (mA/cm^2)\n"
        + "\n".join(f"1e-5,5.0,300,1.0,{th},{10.0 - th * 0.1}" for th in range(0, 90, 10)) + "\n"),
    "ion-velocity-profile": (
        "Anode Flow Rate (mg/s),Discharge Voltage (V),Axial Position from Anode (m),Ion Velocity (m/s)\n"
        + "\n".join(f"5.0,300,{z / 100},{z * 150}" for z in range(10)) + "\n"),
    "two-conditions-unsorted-absolute-wins": (
        "Background Pressure (Torr),Anode Flow Rate (mg/s),Discharge Voltage (V),Thrust (mN),"
        "Thrust absolute uncertainty (mN),Thrust relative uncertainty,Magnetic Field Scale\n"
        "3e-5,5.0,300,82,1.5,0.05,1.1\n1e-5,5.0,300,80,1.0,0.05,0.9\n1e-5,4.0,250,60,1.0,0.05,1.0\n"),
    "empty-cells-and-blank-lines": (
        "Background Pressure (Torr),Anode Flow Rate (mg/s),Discharge Voltage (V),Thrust (mN),"
        "Discharge Current (A)\n1e-5,5.0,300,80,\n\n3e-5,5.0,300,,4.6\n"),
    "unit-case-and-spaces": (
        "  DISCHARGE VOLTAGE ( V ) , anode mass flow rate (KG/S),Thrust (N)\n300,5e-6,0.08\n"),
}


def _write(tmp_path, text, name="d.csv"):
    p = tmp_path / name
    p.write_text(text)
    return p


def _assert_entries_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.operating_condition == b.operating_condition
        assert list(a.data) == list(b.data)
        for k in a.data:
            fa, fb = a.data[k], b.data[k]
            assert fa.unit == fb.unit and list(fa.coords) == list(fb.coords), k
            assert type(fa.val) is type(fb.val) or np.ndim(fb.val) == 0, k
            pairs = [(fa.val, fb.val), (fa.std, fb.std)] + [(fa.coords[c], fb.coords[c]) for c in fa.coords]
            for x, y in pairs:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


@pytest.mark.parametrize("name", [p.name for p in T.spt100_datasets()])
def test_bundled_csv_matches_jax(name):
    _assert_entries_equal(T.load_ht_dataset(T.SPT100_DATA_DIR / name),
                          J.load_ht_dataset(J.SPT100_DATA_DIR / name))


def test_bundled_copies_are_byte_equal():
    names = sorted(p.name for p in J.SPT100_DATA_DIR.iterdir() if p.is_file())
    assert names == sorted(p.name for p in T.SPT100_DATA_DIR.iterdir() if p.is_file())
    assert "README.md" in names and len(names) == 5
    for n in names:
        assert (T.SPT100_DATA_DIR / n).read_bytes() == (J.SPT100_DATA_DIR / n).read_bytes(), n
    assert [p.name for p in T.spt100_datasets()] == [p.name for p in J.spt100_datasets()]


@pytest.mark.parametrize("qois", [(), ("thrust",), ("ion velocity", "ion current density")])
def test_spt100_data_matches_jax(qois):
    _assert_entries_equal(T.spt100_data(qois), J.spt100_data(qois))
    entries = T.load_multiple_datasets(T.spt100_datasets())
    _assert_entries_equal(entries, J.load_multiple_datasets(J.spt100_datasets()))
    assert len(entries) == 23


@pytest.mark.parametrize("case", list(CASES))
def test_synthetic_csv_matches_jax(tmp_path, case):
    f = _write(tmp_path, CASES[case])
    _assert_entries_equal(T.load_ht_dataset(f), J.load_ht_dataset(f))
    _assert_entries_equal(T.load_single_dataset(f), J.load_single_dataset(f))


@pytest.mark.parametrize("text", [
    "Anode Flow Rate (mg/s),Discharge Voltage (V),Ion Current Density (A/m^2)\n5.0,300,100\n",
    "Anode Flow Rate (mg/s),Discharge Voltage (V),Radial Position from Thruster Exit (m),"
    "Ion Current Density (A/m^2)\n5.0,300,1.0,100\n",
    "Anode Flow Rate (mg/s),Discharge Voltage (V),Ion Velocity (m/s)\n5.0,300,100\n",
    "Anode Flow Rate (mg/s),Thrust (mN)\n5.0,80\n",
    "Anode Flow Rate (mg/s),Discharge Voltage (V),Thrust (lbf)\n5.0,300,80\n",
], ids=["icd-j-only", "icd-no-theta", "iv-no-z", "no-voltage", "unknown-unit"])
def test_partial_columns_raise_like_jax(tmp_path, text):
    f = _write(tmp_path, text)
    with pytest.raises(ValueError) as ref:
        J.load_ht_dataset(f)
    with pytest.raises(ValueError) as got:
        T.load_ht_dataset(f)
    assert str(got.value) == str(ref.value)


def test_custom_schema_matches_jax(tmp_path):
    f = _write(tmp_path, CASES["two-conditions-unsorted-absolute-wins"])
    op_vars = {"discharge voltage": {"unit": "V"}, "anode mass flow rate": {"unit": "kg/s"}}
    qois = {"thrust": {"unit": "mN"}}
    _assert_entries_equal(T.load_ht_dataset(f, op_vars=op_vars, qois=qois),
                          J.load_ht_dataset(f, op_vars=op_vars, qois=qois))
    with pytest.raises(ValueError):
        T.load_ht_dataset(f, op_vars={**op_vars, "missing": {"unit": ""}})


@pytest.mark.parametrize("qoi", ["thrust", "discharge current", "ion velocity", "ion current density",
                                 "none"])
def test_data_to_arrays_matches_jax(qoi):
    ref, got = J.data_to_arrays(J.spt100_data(), qoi), T.data_to_arrays(T.spt100_data(), qoi)
    assert list(got[0]) == list(ref[0])
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k])
    for a, b in zip(got[1:], ref[1:]):
        assert type(a) is type(b)
        for x, y in zip(a, b) if isinstance(a, list) else [(a, b)]:
            np.testing.assert_array_equal(x, y)


def test_pem_to_dataentries_matches_jax():
    rng = np.random.default_rng(0)
    outputs = {
        "T": np.array([0.081, 0.082]), "T_c": np.array([[0.07, 0.079], [0.071, 0.08]]),
        "I_d": np.array([4.4, 4.5]), "V_cc": np.array([31.0, 32.0]),
        "u_ion": rng.random((2, 10)), "u_ion_coords": np.tile(np.linspace(0, 0.08, 10), (2, 1)),
        "j_ion": rng.random((2, 91)), "j_ion_coords": np.tile(np.linspace(0, np.pi / 2, 91), (2, 1)),
    }
    ops = [e.operating_condition for e in J.spt100_data()[:2]]
    for kw in (dict(), dict(sweep_radii=[1.0], use_corrected_thrust=False)):
        ref = J.pem_to_dataentries(ops, outputs, **kw)
        _assert_entries_equal(T.pem_to_dataentries(ops, outputs, **kw), ref)
        tensors = {k: torch.as_tensor(v) for k, v in outputs.items()}
        _assert_entries_equal(T.pem_to_dataentries(ops, tensors, **kw), ref)
        # without xarray both packages' pem_to_xarray return the same plain entries
        _assert_entries_equal(T.pem_to_xarray(ops, tensors, **kw), J.pem_to_xarray(ops, outputs, **kw))
