"""The readings that the check's limits are set from, without a measured window.

    python3 pembench/control.py --workload <cell> --seeds 1,2,3 --side program|control|perturbed [--dump f.npz]

For each seed it takes the call and the rows that the check of a run takes
(:class:`pembench.run.CheckDraw`, over a window of ``CALLS`` completed calls),
computes them on one side, and compares them with the plain reference in
float32 on the same rows (:mod:`pembench.check`):

- ``program``: the timed path, ``System.predict`` on the whole call; its line
  also gives the readings of faults planted in the program's outputs of that
  call (:data:`FAULTS`);
- ``control``: the plain reference computed in bfloat16, the precision below
  the float32 that the configuration states, in the program's place;
- ``perturbed``: the plain reference in float32 with the input ``a_1`` one
  float32 step up: how far rounding alone moves the numbers compared.

One JSON line a seed: the seed, the numbers compared and the seconds each side
took; ``--dump`` keeps every compared array (float32, as both sides compute
them). The limits in ``pembench/limits/<cell>.json`` lie between the program's
readings over a dozen seeds or more and the control's. The tests run the
control at a tiny size on the CPU (``pembench/tests``); the benchmark's runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--workload", required=True)
parser.add_argument("--seeds", required=True, help="comma-separated seeds")
parser.add_argument("--side", choices=("program", "control", "perturbed"), required=True)
parser.add_argument("--dump", default=None, help="an .npz to keep every compared array in, per seed")
parser.add_argument("--device", default="cuda")

#: the calls a window completes, among which the check's call is drawn
CALLS = 16


def _half_rows(got: dict, rows: np.ndarray, n: int) -> dict:
    """The rows of the call's second half given the mean of its first half's."""
    late = rows >= n // 2
    out = {k: v.copy() for k, v in got.items()}
    for v in out.values():
        v[late] = np.nanmean(v[~late], axis=0)
    return out


def _one_row(got: dict, rows: np.ndarray, n: int) -> dict:
    """The first row with a discharge given the next such row's outputs, as an
    index off by one would."""
    ok = np.flatnonzero(np.isfinite(got["T"]))
    out = {k: v.copy() for k, v in got.items()}
    if len(ok) > 1:
        for v in out.values():
            v[ok[0]] = v[ok[1]]
    return out


def _one_answer(got: dict, rows: np.ndarray, n: int) -> dict:
    """The current density of the first row with a beam altered by 1%."""
    j = got["j_ion"].copy()
    j[np.flatnonzero(np.isfinite(got["I_B0"]))[:1]] *= 1.01
    return dict(got, j_ion=j)


#: faults planted in the program's outputs of the checked call: name -> (outputs, call rows, rows a call) -> outputs
FAULTS = {"half the rows": _half_rows, "a row from another": _one_row, "one answer altered": _one_answer}


def readings(workload: str, seeds: list, side: str, device: str = "cuda"):
    """Yield one record per seed (see the module's note)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from pembench import check
    from pembench.run import CheckDraw, load_cell, sized
    from pembench.traffic import Traffic

    cpu = device == "cpu"
    spec = load_cell(workload, cpu)
    doc, limits, reference = spec["doc"], spec["limits"], spec["reference"]
    system = None
    if side == "program":
        from hallthrusterpem_tpu_torch.core.json_loader import load_system

        system = load_system(spec["config_file"], device=device)
        sized(system, doc)
    for seed in seeds:
        traffic = Traffic(doc, spec["mix"], seed)
        n = min(traffic.rows, 4) if cpu else traffic.rows
        checked = CheckDraw(seed)
        pick = [k for k in range(CALLS) if checked.offer()][-1]
        rows = {k: v[:n] for k, v in traffic.call(pick).items()}
        sample = checked.sample(n, limits)
        part = {k: v[sample] for k, v in rows.items()}
        t0 = time.perf_counter()
        if side == "program":
            out = system.predict(rows, use_model=doc["use_model"])
            got = {k: out[k].detach().to("cpu", torch.float64).numpy()[sample] for k in check.COMPARED}
            del out
        elif side == "control":
            got = reference.predict(doc, part, doc["use_model"], torch.bfloat16, device, batch=rows)
        else:  # the reference again with a_1 one float32 step up: how far rounding alone moves it
            moved = dict(part, a_1=np.nextafter(part["a_1"], np.float32(np.inf)))
            got = reference.predict(doc, moved, doc["use_model"], torch.float32, device, batch=rows)
        t1 = time.perf_counter()
        ref = reference.predict(doc, part, doc["use_model"], torch.float32, device, batch=rows)
        t2 = time.perf_counter()
        record = {"workload": workload, "side": side, "seed": seed, "call": pick, "rows": len(sample),
                  "numbers": check.readings(got, ref, limits["trace_points"]), "side_s": t1 - t0,
                  "reference_s": t2 - t1, "arrays": {"got": got, "ref": ref}}
        if side == "program":
            record["faults"] = {name: check.readings(plant(got, sample, n), ref, limits["trace_points"])
                                for name, plant in FAULTS.items()}
        yield record


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    kept = {}
    for record in readings(args.workload, seeds, args.side, args.device):
        arrays = record.pop("arrays")
        kept.update({f"{side}_{record['seed']}_{k}": v.astype(np.float32)
                     for side, d in arrays.items() for k, v in d.items()})
        print(json.dumps(record), flush=True)
        if args.dump:
            np.savez_compressed(args.dump, **kept)
    return 0


if __name__ == "__main__":
    sys.exit(main())
