"""CSV loader implementing the Hall-thruster data conventions (the JAX package's
``data/loader.py``), read with :mod:`csv` and numpy: no pandas.

Columns match case-insensitively as ``name (unit)`` through a rename map; units
convert to SI; rows group by operating condition (discharge voltage, anode flow
rate, background pressure, magnetic field scale), in the order ``np.unique``
sorts the op-variable matrix rounded to 12 decimals; uncertainties are absolute
or relative, quoted at 2 sigma (2% relative where absent) and stored as 1 sigma;
the anode flow may derive from the total flow and a flow ratio or fraction; field
quantities (ion velocity vs z, ion current density vs r and theta) keep their
coordinates. A cell parses with Python's ``float``; an empty cell is NaN.
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

__all__ = [
    "DataField",
    "DataEntry",
    "DataInstance",
    "load_single_dataset",
    "load_multiple_datasets",
    "HT_OP_VARS",
    "HT_COORDS",
    "HT_QOIS",
    "HT_RENAME_MAP",
    "HT_DERIVED_COLS",
    "load_ht_dataset",
    "load_ht_datasets",
    "data_to_arrays",
    "pem_to_dataentries",
    "pem_to_xarray",
]

# ---------------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------------
HT_OP_VARS = {
    "discharge voltage": {"unit": "V"},
    "anode mass flow rate": {"unit": "kg/s"},
    "background pressure": {"unit": "Torr", "default": 0.0},
    "magnetic field scale": {"unit": "", "default": 1.0},
}

HT_COORDS = {"z": "m", "r": "m", "theta": "rad"}

HT_QOIS = {
    "cathode coupling voltage": {"unit": "V"},
    "discharge current": {"unit": "A"},
    "thrust": {"unit": "N"},
    "ion velocity": {"unit": "m/s", "coords": ("z",)},
    "ion current density": {"unit": "A/m^2", "coords": ("r", "theta")},
}

HT_RENAME_MAP = {
    "anode voltage": "discharge voltage",
    "anode current": "discharge current",
    "anode flow rate": "anode mass flow rate",
    "axial distance from anode": "z",
    "axial position from anode": "z",
    "axial ion velocity": "ion velocity",
    "angular position from thruster centerline": "theta",
    "radial position from thruster exit": "r",
}

# unit conversions to the canonical units
_UNIT_SCALE = {
    ("mg/s", "kg/s"): 1e-6,
    ("kg/s", "kg/s"): 1.0,
    ("mn", "n"): 1e-3,
    ("n", "n"): 1.0,
    ("ma/cm^2", "a/m^2"): 10.0,
    ("a/m^2", "a/m^2"): 1.0,
    ("deg", "rad"): np.pi / 180.0,
    ("rad", "rad"): 1.0,
}

_DEFAULT_REL_UNCERTAINTY = 0.02  # 2% relative, quoted at 2 sigma


@dataclass
class DerivedColumn:
    target: str
    required: list
    compute: Callable
    unit_from: str = ""


def _flow_from_ratio(cols):
    r = cols["anode-cathode flow ratio"]
    return cols["total flow rate"] * r / (1 + r)


def _flow_from_fraction(cols):
    return cols["total flow rate"] * (1 - cols["cathode flow fraction"])


HT_DERIVED_COLS = [
    DerivedColumn("anode mass flow rate", ["total flow rate", "anode-cathode flow ratio"],
                  _flow_from_ratio, "total flow rate"),
    DerivedColumn("anode mass flow rate", ["total flow rate", "cathode flow fraction"],
                  _flow_from_fraction, "total flow rate"),
]


# ---------------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------------
@dataclass
class DataField:
    """One measured quantity: value(s), 1-sigma std, optional coordinates."""

    val: np.ndarray
    std: Optional[np.ndarray] = None
    unit: str = ""
    coords: dict = field(default_factory=dict)


@dataclass
class DataEntry:
    """All measurements at one operating condition."""

    operating_condition: dict
    data: dict  # name -> DataField


#: the qoi-name -> DataField mapping attached to a DataEntry
DataInstance = dict


# ---------------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------------
_COL_RE = re.compile(r"^\s*(.*?)\s*(?:\(([^)]*)\))?\s*$")


def _parse_header(header: list) -> list[tuple[str, str]]:
    """Each column's (canonical name, unit): case-insensitive, through the rename map."""
    out = []
    for col in header:
        m = _COL_RE.match(str(col).strip().lower())
        name, unit = m.group(1), (m.group(2) or "").strip().lower()
        out.append((HT_RENAME_MAP.get(name, name), unit))
    return out


def _column(cells: list) -> np.ndarray:
    """A column's cells as float64 (an empty cell is NaN), or as strings when
    any cell is not a number."""
    try:
        return np.array([float(c) if c.strip() else np.nan for c in cells], dtype=np.float64)
    except ValueError:
        return np.array(cells, dtype=object)


def _read_csv(file) -> tuple[list, list]:
    """(header, columns) of a CSV file with one header row; blank lines are
    skipped and a short row's missing cells are empty."""
    with open(file, newline="", encoding="utf-8") as fd:
        rows = [r for r in csv.reader(fd) if r]
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{file}: row {i + 2} has {len(r)} fields, the header {len(header)}")
    body = [r + [""] * (len(header) - len(r)) for r in body]
    return header, [_column([r[j] for r in body]) for j in range(len(header))]


def _convert(values, unit: str, target_unit: str) -> np.ndarray:
    key = (unit.lower(), target_unit.lower())
    scale = _UNIT_SCALE.get(key)
    if scale is None:
        if unit.lower() == target_unit.lower() or not target_unit:
            scale = 1.0
        else:
            raise ValueError(f"Cannot convert unit {unit!r} -> {target_unit!r}")
    return np.asarray(values, dtype=np.float64) * scale


def load_ht_dataset(file, op_vars: Optional[dict] = None, qois: Optional[dict] = None) -> list[DataEntry]:
    """Load one Hall-thruster CSV into per-operating-condition DataEntry records;
    custom ``op_vars``/``qois`` replace the defaults."""
    op_vars = op_vars if op_vars is not None else HT_OP_VARS
    qois = qois if qois is not None else HT_QOIS

    header, columns = _read_csv(file)
    n_rows = len(columns[0]) if columns else 0
    work: dict[str, np.ndarray] = {}  # canonical name -> column (the first of that name)
    units: dict[str, str] = {}
    for (name, unit), col in zip(_parse_header(header), columns):
        if name not in work:
            work[name], units[name] = col, unit

    # derived columns: the first spec whose required columns exist wins
    for spec in HT_DERIVED_COLS:
        if spec.target in work:
            continue
        if all(r in work for r in spec.required):
            work[spec.target] = spec.compute(work)
            units[spec.target] = units.get(spec.unit_from, "")

    for mandatory in ("discharge voltage", "anode mass flow rate"):
        if mandatory not in work:
            raise ValueError(f"Missing mandatory operating variable column: {mandatory}")

    # operating-variable values in their units, or their defaults
    op_cols = {}
    for name, spec in op_vars.items():
        if name in work:
            op_cols[name] = _convert(work[name], units.get(name, spec["unit"]), spec["unit"])
        elif "default" in spec:
            op_cols[name] = np.full(n_rows, spec["default"])
        else:
            raise ValueError(f"Missing operating variable: {name}")

    # ion current density needs all three of (r, theta, j); 1-2 of them is an error
    icd_cols = [c for c in ("r", "theta", "ion current density") if c in work]
    if 0 < len(icd_cols) < 3:
        raise ValueError(f"Ion current density requires r, theta and j columns; found only {icd_cols}")
    iv_cols = [c for c in ("z", "ion velocity") if c in work]
    if len(iv_cols) == 1:
        raise ValueError(f"Ion velocity requires both z and velocity columns; found only {iv_cols}")

    # group rows by unique operating condition (np.unique's order)
    op_matrix = np.stack([np.round(op_cols[k], 12) for k in op_vars], axis=-1)
    _, first_idx, inverse = np.unique(op_matrix, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)

    entries: list[DataEntry] = []
    for g, row0 in enumerate(first_idx):
        rows = np.where(inverse == g)[0]
        opcond = {k: float(op_cols[k][row0]) for k in op_vars}
        fields: dict[str, DataField] = {}
        for qoi, spec in qois.items():
            if qoi not in work:
                continue
            target_unit = spec["unit"]
            val = _convert(work[qoi][rows], units.get(qoi, spec["unit"]), target_unit)
            std = _uncertainty(work, units, qoi, rows, val, target_unit)
            coords = {}
            for cname in spec.get("coords", ()):
                if cname in work:
                    coords[cname] = _convert(work[cname][rows], units.get(cname, HT_COORDS[cname]),
                                             HT_COORDS[cname])
            if not spec.get("coords"):
                val, std = val[0], (std[0] if std is not None else None)
            fields[qoi] = DataField(val=val, std=std, unit=spec["unit"], coords=coords)
        entries.append(DataEntry(operating_condition=opcond, data=fields))
    return entries


def load_single_dataset(file, op_vars=None, qois=None, **_kw) -> list[DataEntry]:
    """The generic CSV loader that :func:`load_ht_dataset` wraps with the
    Hall-thruster defaults."""
    return load_ht_dataset(file, op_vars=op_vars, qois=qois)


def load_multiple_datasets(files, op_vars=None, qois=None, **_kw) -> list[DataEntry]:
    return load_ht_datasets(files, op_vars=op_vars, qois=qois)


def _uncertainty(work, units, qoi, rows, val, target_unit):
    """Absolute wins over relative; default 2% relative; quoted at 2 sigma,
    returned as 1 sigma."""
    abs_col = f"{qoi} absolute uncertainty"
    rel_col = f"{qoi} relative uncertainty"
    if abs_col in work:
        two_sigma = _convert(work[abs_col][rows], units.get(abs_col, target_unit), target_unit)
    elif rel_col in work:
        two_sigma = np.asarray(work[rel_col][rows], dtype=np.float64) * np.abs(val)
    else:
        two_sigma = _DEFAULT_REL_UNCERTAINTY * np.abs(val)
    return two_sigma / 2.0


def load_ht_datasets(files, op_vars=None, qois=None) -> list[DataEntry]:
    """Load and concatenate several CSVs, in the order given."""
    entries: list[DataEntry] = []
    for f in files:
        entries.extend(load_ht_dataset(f, op_vars=op_vars, qois=qois))
    return entries


# ---------------------------------------------------------------------------------
# Bridges to the PEM
# ---------------------------------------------------------------------------------
def data_to_arrays(entries: list[DataEntry], qoi: str):
    """Stack one QoI across operating conditions: returns (op_conditions dict of
    (N,) arrays, values, sigmas); lists where the conditions' shapes differ."""
    sel = [e for e in entries if qoi in e.data]
    if not sel:
        return {}, np.empty(0), np.empty(0)
    ops = {k: np.asarray([e.operating_condition[k] for e in sel]) for k in sel[0].operating_condition}
    vals = [np.atleast_1d(e.data[qoi].val) for e in sel]
    stds = [np.atleast_1d(e.data[qoi].std) if e.data[qoi].std is not None else np.full_like(vals[i], np.nan)
            for i, e in enumerate(sel)]
    if all(v.shape == vals[0].shape for v in vals):
        return ops, np.stack(vals), np.stack(stds)
    return ops, vals, stds


def pem_to_dataentries(operating_conditions, outputs, sweep_radii=None, use_corrected_thrust=True):
    """Batched PEM outputs (numpy arrays or tensors) as DataEntry records for a
    model-data comparison, one per operating condition."""
    from hallthrusterpem_tpu_torch.core.dataset import to_numpy

    outputs = {k: to_numpy(v) for k, v in outputs.items()}
    entries = []
    for i, opcond in enumerate(operating_conditions):
        fields = {}
        thrust = outputs["T_c"] if (use_corrected_thrust and "T_c" in outputs) else outputs.get("T")
        if thrust is not None:
            tv = np.atleast_1d(np.asarray(thrust)[i])
            fields["thrust"] = DataField(val=tv[-1] if tv.ndim else tv, unit="N")
        if "I_d" in outputs:
            fields["discharge current"] = DataField(val=np.asarray(outputs["I_d"])[i], unit="A")
        if "V_cc" in outputs:
            fields["cathode coupling voltage"] = DataField(val=np.asarray(outputs["V_cc"])[i], unit="V")
        if "u_ion" in outputs:
            fields["ion velocity"] = DataField(
                val=np.asarray(outputs["u_ion"])[i], unit="m/s",
                coords={"z": np.asarray(outputs["u_ion_coords"])[i]},
            )
        if "j_ion" in outputs:
            coords = {"theta": np.asarray(outputs["j_ion_coords"])[i]}
            if sweep_radii is not None:
                coords["r"] = np.asarray(sweep_radii)
            fields["ion current density"] = DataField(
                val=np.asarray(outputs["j_ion"])[i], unit="A/m^2", coords=coords
            )
        entries.append(DataEntry(operating_condition=dict(opcond), data=fields))
    return entries


def pem_to_xarray(operating_conditions, outputs, sweep_radii=None, use_corrected_thrust=True):
    """:func:`pem_to_dataentries` with each field's values as an
    ``xarray.DataArray`` over its coordinates; plain arrays where xarray is not
    installed (xarray is imported here, not with the module)."""
    entries = pem_to_dataentries(operating_conditions, outputs, sweep_radii, use_corrected_thrust)
    try:
        import xarray as xr
    except ImportError:
        return entries
    for e in entries:
        for name, f in e.data.items():
            if f.coords:
                dims = list(f.coords)
                coords = {d: np.atleast_1d(f.coords[d]) for d in dims}
                val = np.asarray(f.val)
                if name == "ion current density" and "r" in coords and val.ndim == 1:
                    val = val[None, :] if len(coords["r"]) == 1 else val
                f.val = xr.DataArray(val, coords=coords, dims=dims[: val.ndim])
            else:
                f.val = xr.DataArray(f.val)
    return entries
