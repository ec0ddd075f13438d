"""The card's kernel-against-lax parity artifact ``runs/h100/parity.json``:
``python -m hallthrusterpem_tpu_torch.scripts.parity_tpu`` run uncut (2e-3 s,
B = 32) on an NVIDIA H100, validated as ``tests/test_parity_artifact.py``
validates the TPU's: produced on the card, the nominal point and at least three
corners, each passing its mask, attractor and QoI gates. It skips while the
artifact is absent (a full run takes hours of card time)."""

import json
from pathlib import Path

import pytest

ARTIFACT = Path(__file__).resolve().parents[1] / "runs" / "h100" / "parity.json"


@pytest.mark.skipif(not ARTIFACT.exists(), reason="the card's parity artifact is not generated yet")
def test_h100_parity_artifact_valid_and_passing():
    art = json.loads(ARTIFACT.read_text())
    assert art["platform"] == "gpu" and "H100" in art["device"], (art["platform"], art["device"])
    assert art["power_limit"] and art["power_limit"].endswith("W"), art["power_limit"]
    names = {c["condition"]["name"] for c in art["configs"]}
    assert "nominal_300V_5.16mg" in names and len(names) >= 4
    for entry in art["configs"]:
        name = entry["condition"]["name"]
        assert entry["pass"], f"parity failed for {name}: {entry['qois']}"
        assert entry["finite"]["mask_agreement"] >= art["min_mask_agreement"]
        assert entry["finite"]["attractor_agreement"] >= art["min_mask_agreement"]
        assert entry["steps"] > 800_000 and entry["lax_ms_per_step"] > 0 and entry["kstep_launches"] > 0, name
        for qoi, rec in entry["qois"].items():
            assert rec["median_rel"] < rec["tol_median"], (qoi, rec)
            assert rec["p90_rel"] < rec["tol_p90"], (qoi, rec)
    assert art["pass"] is True
