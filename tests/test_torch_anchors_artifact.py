"""The committed card artifact ``runs/h100/anchors.json``: the port's
``python -m hallthrusterpem_tpu_torch.scripts.anchors`` run on an NVIDIA H100
(``chip_smoke.py`` phase 19 writes it). It must name the card, hold all 10
anchored conditions (4 scalar, 3 u_ion LIF pressures, 3 j_ion Faraday
pressures, as the TPU run's ``runs/r5/anchors.json``) and claim a tolerance
table no looser than the one ``tests/test_anchors_artifact.py`` pins and
``scripts/anchors.py`` states. Each verdict it records must follow from its
own numbers; whether the card run met the table is recorded, not asserted."""

import importlib.util
import json
import math
from pathlib import Path

import pytest

from test_anchors_artifact import DESIGN_TOL_CEILING

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "runs" / "h100" / "anchors.json"
TPU_ARTIFACT = ROOT / "runs" / "r5" / "anchors.json"


def _jax_anchors():
    spec = importlib.util.spec_from_file_location("jax_anchors", ROOT / "scripts" / "anchors.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("check", ["device", "conditions", "tolerances"])
def test_h100_anchor_artifact(check):
    art = json.loads(ARTIFACT.read_text())
    conds = {c["name"]: c for c in art["conditions"]}
    if check == "device":
        assert art["platform"] == "gpu" and "H100" in art["device"], (art["platform"], art["device"])
        assert art["power_limit"] and art["power_limit"].endswith("W"), art["power_limit"]
        assert art["config"] == "hallthrusterpem_tpu_torch/configs/pem_v0_SPT-100.json"
    elif check == "conditions":
        tpu = [c["name"] for c in json.loads(TPU_ARTIFACT.read_text())["conditions"]]
        assert list(conds) == tpu and len(conds) == 10
        assert sum(n.startswith(p) for n in conds for p in ("uion", "jion")) == 6
        for c in art["conditions"]:
            for q, rec in c["qois"].items():
                err = rec.get("rel_err", rec.get("rel_l2"))
                assert math.isfinite(err), (c["name"], q)
                if abs(err - rec["tol"]) > 5e-5:  # the artifact rounds errors to 4 decimals
                    assert rec["pass"] == (err <= rec["tol"]), (c["name"], q, rec)
            assert c["pass"] == all(r["pass"] for r in c["qois"].values()), c["name"]
        assert art["pass"] == all(c["pass"] for c in art["conditions"])
    else:
        jax = _jax_anchors()
        nominal = next(c for n, c in conds.items() if n.startswith("diamant"))
        assert set(nominal["qois"]) == set(DESIGN_TOL_CEILING)
        for q, ceiling in DESIGN_TOL_CEILING.items():
            assert nominal["qois"][q]["tol"] <= ceiling, q
        for anchor in jax.SCALAR_ANCHORS:
            for q, tol in anchor["tol"].items():
                assert conds[anchor["name"]]["qois"][q]["tol"] <= tol, (anchor["name"], q)
        for n, c in conds.items():
            if n.startswith("uion"):
                assert c["qois"]["u_ion"]["tol"] <= min(jax.UION_TOL, 0.16), n
            if n.startswith("jion"):
                pb = c["operating"]["P_b"]
                assert c["qois"]["j_ion"]["tol"] <= jax.JION_TOL[min(jax.JION_TOL, key=lambda p: abs(p - pb))], n
