"""Experimental-data loading for Hall-thruster PEMs (the JAX package's ``data``):
the CSV loader of :mod:`.loader` and the bundled SPT-100 datasets, the port's own
copies under ``data/spt100/`` (provenance in its ``README.md``).
"""

from pathlib import Path as _Path

from hallthrusterpem_tpu_torch.data.loader import (
    HT_COORDS,
    HT_DERIVED_COLS,
    HT_OP_VARS,
    HT_QOIS,
    HT_RENAME_MAP,
    DataEntry,
    DataField,
    DataInstance,
    data_to_arrays,
    load_ht_dataset,
    load_ht_datasets,
    load_multiple_datasets,
    load_single_dataset,
    pem_to_dataentries,
    pem_to_xarray,
)

#: the bundled SPT-100 experimental datasets (literature reconstructions)
SPT100_DATA_DIR = _Path(__file__).parent / "spt100"

def spt100_datasets() -> list:
    """Paths of all bundled SPT-100 experimental CSVs, sorted."""
    return sorted(SPT100_DATA_DIR.glob("*.csv"))


def spt100_data(qois: tuple = ()) -> list[DataEntry]:
    """The bundled SPT-100 experimental data as DataEntry records; with
    ``qois``, only the entries holding at least one of these QoI names (e.g.
    ``("thrust", "ion velocity")``)."""
    entries = load_ht_datasets(spt100_datasets())
    if qois:
        entries = [e for e in entries if any(q in e.data for q in qois)]
    return entries


__all__ = [
    "SPT100_DATA_DIR",
    "spt100_data",
    "spt100_datasets",
    "DataEntry",
    "DataField",
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
