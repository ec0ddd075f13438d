"""The readings that the check's limits are set from, without a measured window.

    python3 pembench/control.py --workload <cell> --seeds 1,2,3 --side program|<side> [--dump f.npz]

For each seed it takes the call and the rows that the check of a run takes
(:class:`pembench.run.CheckDraw`, over a window of ``CALLS`` completed calls),
computes them on one side, and compares them with the plain reference on the
same rows, through the operation that the cell's configuration names (see
``pembench/run.py``):

- ``program``: the timed path, the operation's call on the whole call; its
  line also gives the readings of the operation's ``faults``, planted in the
  program's outputs of that call;
- any of the operation's ``sides``; every operation has ``control``, the plain
  reference in the precision below the one that the configuration states, in
  the program's place. For ``predict``: the reference in bfloat16, and
  ``perturbed``, the reference in float32 with the input ``a_1`` one float32
  step up: how far rounding alone moves the numbers compared.

One JSON line a seed: the seed, the numbers compared and the seconds each side
took; ``--dump`` keeps every compared array (float32). The
limits in ``pembench/limits/<cell>.json`` lie between the program's readings
over a dozen seeds or more and the control's. The tests run the control at a
tiny size on the CPU (``pembench/tests``); the benchmark's runs never run it.
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
parser.add_argument("--side", required=True, help="'program', or one of the operation's sides such as 'control'")
parser.add_argument("--dump", default=None, help="an .npz to keep every compared array in, per seed")
parser.add_argument("--device", default="cuda")

#: the calls a window completes, among which the check's call is drawn
CALLS = 16


def readings(workload: str, seeds: list, side: str, device: str = "cuda"):
    """Yield one record per seed (see the module's note)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from pembench.run import CheckDraw, load_cell

    spec = load_cell(workload, device == "cpu")
    device = torch.device(device)
    for seed in seeds:
        op = spec["operation"].Operation(spec, seed, device)
        if side != "program" and side not in op.sides:
            raise ValueError(f"{workload}'s operation has no side {side!r}: 'program' or one of {op.sides}")
        checked = CheckDraw(seed)
        pick = [k for k in range(CALLS) if checked.offer()][-1]
        sample = checked.sample(op.rows_per_call, spec["limits"])
        t0 = time.perf_counter()
        if side == "program":
            out = op.call(op.inputs(pick))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            op.done(pick, out, True)
            del out
            got = op.kept(sample)[1]
        else:
            got = op.expected(pick, sample, side)
        t1 = time.perf_counter()
        ref = op.expected(pick, sample)
        t2 = time.perf_counter()
        record = {"workload": workload, "side": side, "seed": seed, "call": pick, "rows": len(sample),
                  "numbers": op.readings(got, ref), "side_s": t1 - t0, "reference_s": t2 - t1,
                  "arrays": {"got": got, "ref": ref}}
        if side == "program":
            record["faults"] = {name: op.readings(plant(got, sample, op.rows_per_call), ref)
                                for name, plant in op.faults.items()}
        del op
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
