"""Cathode coupling model (Jorns 2021), the JAX package's ``models/cathode.py``:
``V_cc = V_vac + T_e ln(1 + P/P_T) - T_e P / (P_T + P*)``, clamped to ``[0, V_a]``."""

from __future__ import annotations

import torch

from hallthrusterpem_tpu_torch.constants import TORR_2_PA

__all__ = ["cathode_coupling"]


def cathode_coupling(inputs: dict) -> dict:
    """``P_b``, ``Pstar``, ``P_T`` in Torr, ``V_a`` and ``V_vac`` in V, ``T_e`` in eV
    (tensors of one broadcast shape) -> ``{'V_cc': ...}`` in V."""
    PB = inputs["P_b"] * TORR_2_PA
    Va = inputs["V_a"]
    Te = inputs["T_e"]
    Pstar = inputs["Pstar"] * TORR_2_PA
    PT = inputs["P_T"] * TORR_2_PA

    V_cc = inputs["V_vac"] + Te * torch.log1p(PB / PT) - (Te / (PT + Pstar)) * PB
    V_cc = torch.clamp(V_cc, min=torch.zeros_like(Va), max=Va)
    return {"V_cc": torch.atleast_1d(V_cc)}
