"""The comparison that decides ``correct``: a call's outputs against the plain
reference's on the same rows.

The discharge oscillates, and over a whole call two sound float32 solvers part
on some rows as two runs of a breathing plasma do: the plain reference moved by
one float32 step in one input reads the same widest gaps against itself as the
program does against it. So the number over the discharge's time averages is
taken at the median row, and the rows are held one by one through the trace's
first samples, where two sound solvers agree to rounding. The numbers compared,
each with a limit of its own (``pembench/limits/<cell>.json``):

- ``cathode_gap``: the widest gap of the coupling voltage ``V_cc`` over the
  rows compared, as a share of the largest ``|V_cc|``;
- ``trace_gap``: the widest gap, over the rows that both sides give, of the
  discharge current's trace ``I_d(t)`` over its first ``trace_points``
  samples, as a share of the largest ``|I_d|`` there. The trace follows every
  state of the discharge through Ohm's law, so a fault in any row's solve
  shows in it;
- ``discharge_gap``: the median over the rows of each row's widest gap over the
  time-averaged outputs (``T``, ``I_d``, ``I_B0``, the four efficiencies, the
  ``u_ion`` profile), each as a share of the largest value of the rows; a row
  that one side gives and the other not reads 1 (wholly wrong), and rows that
  neither gives are left out;
- ``plume_gap``: the widest gap of the divergence angle and of the current
  density per ampere of beam current (``j_ion / I_B0``), on the rows whose
  discharge both sides give (the plume of a NaN row is NaN); a value only one
  side gives there reads 1;
- ``nonfinite_mismatch``: the share of rows that one side gives as finite and
  the other as not (a NaN row is the thruster guards' answer for the input).

A reading that cannot be taken is NaN, and NaN passes no limit.
:func:`readings` also gives, outside the comparison, the widest row's gap of
each time-averaged output (``widest``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
AVERAGED = ("T", "I_d", "I_B0", "eta_c", "eta_m", "eta_v", "eta_a", "u_ion")
TRACE = "discharge_current_trace"
#: every output of the system the comparison reads
COMPARED = ("V_cc", *AVERAGED, TRACE, "j_ion", "div_angle")
#: the numbers :func:`readings` gives and the ``predict`` operation judges
NUMBERS = ("cathode_gap", "trace_gap", "discharge_gap", "plume_gap", "nonfinite_mismatch")


def _rows_gap(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each row's widest gap, as a share of the largest |ref| of all rows."""
    if not len(ref):
        return np.zeros(0)
    got, ref = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
    scale = np.max(np.abs(ref)) if ref.size else 0.0
    if not scale > 0:
        return np.full(len(ref), np.nan)
    return np.max(np.abs(got - ref), axis=1) / scale


def _paired_gap(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """:func:`_rows_gap` over the rows both sides give as finite, 1 for a row
    only one side gives; rows neither gives are left out."""
    if not len(ref):
        return np.zeros(0)
    got, ref = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
    ok_got, ok_ref = np.isfinite(got).all(axis=1), np.isfinite(ref).all(axis=1)
    both = ok_got & ok_ref
    return np.concatenate([_rows_gap(got[both], ref[both]), np.ones(int((ok_got != ok_ref).sum()))])


def readings(got: dict, ref: dict, trace_points: int = 100) -> dict:
    """Each compared number of ``got`` (the program's outputs of the rows
    compared, name -> array) against ``ref`` (the reference's), and ``widest``."""
    arr = lambda d, k: np.asarray(d[k], np.float64)
    ok_got, ok_ref = np.isfinite(arr(got, "T")), np.isfinite(arr(ref, "T"))
    both, either = ok_got & ok_ref, ok_got | ok_ref
    pick = lambda d, k: arr(d, k)[both]
    worst = lambda gaps: float(np.max(gaps)) if gaps.size and not np.isnan(gaps).any() else float("nan")

    def over_rows(gaps_of_both: np.ndarray, q: float) -> float:
        rows = np.ones(int(either.sum()))  # a row only one side gives reads 1
        rows[both[either]] = gaps_of_both
        return float(np.quantile(rows, q)) if rows.size and not np.isnan(rows).any() else float("nan")

    averaged = {k: _rows_gap(pick(got, k), pick(ref, k)) for k in AVERAGED}
    per_row = np.max(np.stack(list(averaged.values())), axis=0) if both.any() else np.zeros(0)
    trace = _rows_gap(pick(got, TRACE)[:, :trace_points], pick(ref, TRACE)[:, :trace_points])
    with np.errstate(divide="ignore", invalid="ignore"):  # a beam current of 0 gives no ratio
        unit = lambda d: pick(d, "j_ion") / pick(d, "I_B0")[:, None]
        plume = np.concatenate([_paired_gap(pick(got, "div_angle"), pick(ref, "div_angle")),
                                _paired_gap(unit(got), unit(ref))])
    return {"cathode_gap": worst(_paired_gap(arr(got, "V_cc"), arr(ref, "V_cc"))),
            "trace_gap": worst(trace),
            "discharge_gap": over_rows(per_row, 0.5),
            "plume_gap": worst(plume),
            "nonfinite_mismatch": float(np.mean(ok_got != ok_ref)),
            "widest": {k: worst(v) for k, v in averaged.items()}}


def load_limits(cell: str) -> dict:
    with open(ROOT / "limits" / f"{cell}.json", encoding="utf-8") as fd:
        return json.load(fd)


def judge(numbers: dict, limits: dict, names: tuple = NUMBERS) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}) over the
    names of ``limits`` (a limits file's ``limits``) and ``names`` (the numbers
    the operation computes; :func:`readings`' by default). A name that only one of the two holds reads NaN
    there, and NaN passes no limit, so a limits file that leaves out a number
    the operation computes, or names one it does not, is not correct; nor is a
    check with no names."""
    order = [*limits, *(n for n in names if n not in limits)]
    nan = float("nan")
    checks = {n: {"value": numbers.get(n, nan) if n in names else nan, "limit": limits.get(n, nan)}
              for n in order}
    return bool(names) and all(c["value"] <= c["limit"] for c in checks.values()), checks
