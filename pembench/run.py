"""Benchmark of hallthrusterpem_tpu_torch on one NVIDIA H100: a configuration
of the port driven by a closed loop of one client, each call timed, traced and
checked against a plain reference.

    python3 pembench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell's configuration (``pembench/configs/<config>.json``, a
frozen file with its source, cuts and work count), its traffic mix
(``pembench/traffic/<traffic>.json``), the operation that the configuration
names (``pembench/operations/<operation>.py``; ``predict`` where it names
none), each metric's reader (``pembench/metrics/<name before the first
dot>.py``), the configuration's plain reference
(``pembench/reference/<reference>.py``) and the cell's limits
(``pembench/limits/<cell>.json``, ``{"sample_rows", "limits": {name: limit},
...}``, naming each number that the operation's check compares).

An operation module defines ``tiny(doc)``, the configuration at a size a CPU
test can run, and a class ``Operation(spec, seed, device)``, made once a run
from :func:`load_cell`'s ``spec``; making it loads the program. The class
states

- ``kernels``: substrings of the names of the card's kernels whose time the
  traced run gives each call (``kernel_s`` in its record);
- ``numbers``: the names of the numbers its check compares; the cell's limits
  file names exactly these (:func:`pembench.check.judge`);
- ``line_keys``: the keys that :meth:`line` adds to the line's ``calls``;
- ``sides``: the sides besides ``"reference"`` that :meth:`expected` computes,
  ``"control"`` among them (``pembench/control.py``);
- ``faults``: name -> ``plant(got, sample, rows_per_call)``, faults planted in
  the program's compared outputs, which ``pembench/control.py`` reads;

and the object has

- ``rows_per_call``: the rows of a call (``rows`` in its record);
- ``per_call``: further fields that every call's record holds as they are;
- ``inputs(k)``: call ``k``'s inputs, drawn from the seed (k < 0: the
  warm-up's), before the call's clock starts;
- ``call(inputs)``: the timed call; it returns the outputs, which the run
  synchronises on;
- ``counters()``: running totals, read before and after each call; the call's
  record holds the change of each;
- ``done(k, outputs, keep)``: after each completed call, outside its wall; it
  keeps the outputs the check reads when ``keep`` (each kept call replaces the
  last), and what :meth:`line` reads;
- ``least_seconds(k, device_name)``: the least time of call ``k`` on that
  card, or None (traced runs; ``least_s`` in its record);
- ``kept(sample)``: once the window has closed and the peak is read, ``(k,
  got)``: the kept call and its compared outputs on the rows ``sample`` (name
  -> numpy array); None where no call was kept;
- ``expected(k, sample, side="reference")``: the same outputs of call ``k``'s
  rows ``sample`` by the plain reference, or by one of ``sides``;
- ``readings(got, expected)``: the numbers compared, by name;
- ``line(calls, numbers)``: its own keys of the line's ``calls`` object.

A run makes the operation, calls it once at the cell's own shapes (the
kernels are built on a checkout's first run, under ``build/``), then drives a
closed loop of one client for ``--seconds``: each call is issued when the
last has returned and ended by a synchronise. With ``--trace 1`` the window
runs under ``torch.profiler`` and the line gives the per-layer metrics; with
``--trace 0`` it gives the end-to-end ones. After the window one call, drawn
from the seed, is checked on a sample of its rows, drawn from the seed. The
last line of standard output is the result, one JSON object.

The run fails, printing no result, without a CUDA card (``--device cpu`` is a
dry run at a tiny size for the CPU tests, and its line says so), and when the
process holds JAX, Flax or the JAX package ``hallthrusterpem_tpu`` after the
set-up or after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names the run may not hold: JAX, and the JAX package the port began from
FORBIDDEN = ("jax", "jaxlib", "flax", "hallthrusterpem_tpu")

#: the operation of a configuration that names none
DEFAULT_OPERATION = "predict"

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
parser.add_argument("--seed", type=int, required=True)
parser.add_argument("--seconds", type=float, required=True, help="length of the measured window")
parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
parser.add_argument("--device", default="cuda", help="'cpu': a dry run at a tiny size, for the CPU tests")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    return load_module(BENCH / "metrics" / f"{metric.split('.')[0]}.py", f"pembench_metric_{metric}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def load_cell(name: str, cpu: bool = False) -> dict:
    """Everything the benchmark finds by a cell's name: the cell, its
    configuration (file and document; the operation's ``tiny`` on the CPU),
    traffic mix, limits, plain reference and operation module; None when
    BENCHMARK.json has no such cell."""
    from pembench import check
    from pembench.traffic import load_mix

    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as fd:
        bench = json.load(fd)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        return None
    config_file = next(c for c in bench["configs"] if c["name"] == cell["config"])["file"]
    with open(ROOT / config_file, encoding="utf-8") as fd:
        doc = json.load(fd)
    reference = load_module(BENCH / "reference" / f"{doc['reference']}.py", f"pembench_reference_{doc['reference']}")
    op = doc.get("operation", DEFAULT_OPERATION)
    operation = load_module(BENCH / "operations" / f"{op}.py", f"pembench_operation_{op}")
    return {"bench": bench, "cell": cell, "config_file": ROOT / config_file,
            "doc": operation.tiny(doc) if cpu else doc, "mix": load_mix(cell["traffic"]),
            "limits": check.load_limits(name), "reference": reference, "operation": operation}


class CheckDraw:
    """The call the check reads and its rows, drawn from the seed: as the calls
    complete, :meth:`offer` keeps each with a chance of one over the calls
    offered so far (a reservoir of one), so that every completed call is as
    likely; :meth:`sample` then draws the rows of it compared."""

    def __init__(self, seed: int):
        self.rng, self.offered = np.random.default_rng([seed, 2]), 0

    def offer(self) -> bool:
        self.offered += 1
        return bool(self.rng.random() * self.offered < 1.0)

    def sample(self, rows: int, limits: dict) -> np.ndarray:
        return np.sort(self.rng.choice(rows, min(limits["sample_rows"], rows), replace=False))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi not read: {err}"


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    cpu = args.device == "cpu"
    # every build and kernel cache of the run inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "pembench" / sub)
    sys.path.insert(0, str(ROOT))
    spec = load_cell(args.workload, cpu)
    if spec is None:
        print(f"no cell named {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    bench, cell, limits = (spec[k] for k in ("bench", "cell", "limits"))

    import torch

    stages = {"torch": time.perf_counter() - T_START}  # where set-up goes, from the process's start
    if not cpu and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 1
    from pembench import check, trace

    torch.set_num_threads(1)
    stages["imports"] = time.perf_counter() - T_START
    device = torch.device(args.device)
    if not cpu:
        torch.zeros(1, device=device)
    stages["cuda_context"] = time.perf_counter() - T_START
    try:
        op = spec["operation"].Operation(spec, args.seed, device)
    except ImportError as err:
        print(f"the program under test is not in this checkout ({err}): no result", file=sys.stderr)
        return 1
    stages["load_program"] = time.perf_counter() - T_START
    sync = (lambda: torch.cuda.synchronize(device)) if not cpu else (lambda: None)

    op.call(op.inputs(-1))  # warm-up: builds or loads the kernels
    sync()
    stages["warm_up"] = time.perf_counter() - T_START
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
        prof = profile(activities=activities)
        prof.start()
    found = forbidden_modules()
    if found:
        print(f"after the set-up the process holds {found}: no result", file=sys.stderr)
        return 1
    setup_s = time.perf_counter() - T_START

    # ---- the window: a closed loop of one client. The call the check reads is drawn
    # from the seed as the calls complete (CheckDraw), so one call's outputs are kept.
    span = record_function if args.trace else (lambda name: contextlib.nullcontext())
    calls, pick, failed = [], None, 0
    checked = CheckDraw(args.seed)
    with span(trace.WINDOW):
        t_w0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t_w0 < args.seconds:
            rows = op.inputs(k)
            before = op.counters()
            t_a = time.perf_counter()
            try:
                with span(trace.CALL):
                    out = op.call(rows)
                    sync()
                ok = True
            except Exception:  # a call that raises has failed; the loop goes on
                traceback.print_exc()
                out, ok, failed = {}, False, failed + 1
                sync()
            t_b = time.perf_counter()
            after = op.counters()
            calls.append({"k": k, "ok": ok, "rows": op.rows_per_call, **op.per_call, "wall_s": t_b - t_a, "end": t_b,
                          **{n: after[n] - before[n] for n in after}})
            if ok:
                keep = checked.offer()
                op.done(k, out, keep)
                pick = k if keep else pick
            del out
            k += 1
    t_w1 = calls[-1]["end"]
    peak = int(torch.cuda.max_memory_allocated(device)) if not cpu else 0

    ctx = {"calls": calls, "setup_s": setup_s, "window_wall_s": t_w1 - t_w0}
    dev_name = torch.cuda.get_device_name(device) if not cpu else "cpu"
    if prof is not None:
        prof.stop()
        traced = trace.read(prof, op.kernels)
        del prof
        ctx.update(window_s=traced.get("window_s"), busy_s=traced.get("busy_s"))
        for c, ks in zip(calls, traced.get("kernel_s", [])):
            c["kernel_s"] = ks
        for c in calls:
            c["least_s"] = op.least_seconds(c["k"], dev_name)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the check, once the window has closed and the peak is read
    sample = checked.sample(op.rows_per_call, limits) if pick is not None else []
    kept, numbers, ref_s = op.kept(sample), {}, 0.0
    if kept is not None:
        t_r = time.perf_counter()
        expected = op.expected(kept[0], sample)
        ref_s = time.perf_counter() - t_r
        numbers = op.readings(kept[1], expected)
        del kept, expected
    correct, checks = check.judge(numbers, limits["limits"], op.numbers)
    correct = correct and failed == 0

    result = {"correct": bool(correct), "attempted": len(calls), "failed": failed, "metrics": metrics,
              "device": {"platform": "cpu" if cpu else "gpu", "kind": dev_name, "count": 1 if cpu else cell["chips"],
                         "memory_peak_bytes": peak}}
    if cpu:
        result["dry_run"] = "CPU dry run at a tiny size: no number here is a device measurement"
    if args.trace and ctx.get("window_s"):
        result["device"].update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        result["breakdown"] = traced["breakdown"]
    result["calls"] = {
        "rows_per_call": op.rows_per_call, "window_wall_s": ctx["window_wall_s"], **op.line(calls, numbers),
        "setup_stages_s": stages, "checked_call": pick, "checked_rows": len(sample), "reference_s": ref_s,
        "card": card_line() if not cpu else None}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"after the window the process holds {found}: no result", file=sys.stderr)
        return 1
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} against the limit {c['limit']!r}: "
              f"{'within' if c['value'] <= c['limit'] else 'NOT within'}", file=sys.stderr)
    print(json.dumps(finite_or_null(result)), flush=True)
    return 0


def finite_or_null(x):
    """``x`` with every NaN or infinite number as None, so that the line is strict JSON."""
    if isinstance(x, dict):
        return {k: finite_or_null(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite_or_null(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
