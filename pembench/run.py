"""Benchmark of hallthrusterpem_tpu_torch on one NVIDIA H100: the pem_v0
coupled system (cathode -> 1-D discharge -> plume) through ``System.predict``.

    python3 pembench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell's configuration (``pembench/configs/<config>.json``, a
frozen System file with its source, cuts and work count), its traffic mix
(``pembench/traffic/<traffic>.json``, read by :mod:`pembench.traffic`), each
metric's reader (``pembench/metrics/<name before the first dot>.py``), the
configuration's plain reference (``pembench/reference/<reference>.py``) and the
cell's limits (``pembench/limits/<cell>.json``).

A run loads the system on the card, makes one warm-up call at the cell's own
shapes (the kernels are built on a checkout's first run, under ``build/``),
then drives a closed loop of one client for ``--seconds``: each call is issued
when the last has returned and ended by a synchronise. With ``--trace 1`` the
window runs under ``torch.profiler`` and the line gives the per-layer metrics;
with ``--trace 0`` it gives the end-to-end ones. After the window one call,
drawn from the seed, is checked: a sample of its rows, drawn from the seed,
against the plain reference on the same rows (:mod:`pembench.check`). The last
line of standard output is the result, one JSON object.

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
import copy  # noqa: E402
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
#: the kernel whose events the traced run times
KERNEL = "kstep_kernel"

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


def tiny(doc: dict) -> dict:
    """The configuration at a size a CPU test can run: 0.4 us, 20 trace points."""
    doc = copy.deepcopy(doc)
    thr = next(c for c in doc["components"] if c["name"] == "Thruster")
    thr["simulation"].update(duration=4e-7, num_save=20)
    thr["postprocess"]["average_start_time"] = 2e-7
    return doc


def load_cell(name: str, cpu: bool = False) -> dict:
    """Everything the benchmark finds by a cell's name: the cell, its
    configuration (file and document; :func:`tiny` on the CPU), traffic mix,
    limits and plain reference; None when BENCHMARK.json has no such cell."""
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
    return {"bench": bench, "cell": cell, "config_file": ROOT / config_file, "doc": tiny(doc) if cpu else doc,
            "mix": load_mix(cell["traffic"]), "limits": check.load_limits(name), "reference": reference}


def sized(system, doc: dict) -> None:
    """The loaded system at the document's sizes (the dry run's tiny ones)."""
    for comp, src in zip(system.components, doc["components"]):
        comp.model_kwargs.update({k: src[k] for k in ("simulation", "postprocess") if k in src})


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
    bench, cell, doc, limits, reference = (spec[k] for k in ("bench", "cell", "doc", "limits", "reference"))

    import torch

    stages = {"torch": time.perf_counter() - T_START}  # where set-up goes, from the process's start
    if not cpu and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 1
    try:
        from hallthrusterpem_tpu_torch.core.json_loader import load_system
        from hallthrusterpem_tpu_torch.models.thruster import _kernels
    except ImportError as err:
        print(f"the program under test is not in this checkout ({err}): no result", file=sys.stderr)
        return 1
    from pembench import check, trace, work
    from pembench.traffic import Traffic

    torch.set_num_threads(1)
    stages["imports"] = time.perf_counter() - T_START
    device = torch.device(args.device)
    if not cpu:
        torch.zeros(1, device=device)
    stages["cuda_context"] = time.perf_counter() - T_START
    system = load_system(spec["config_file"], device=device)
    stages["load_system"] = time.perf_counter() - T_START
    if cpu:
        sized(system, doc)
    traffic = Traffic(doc, spec["mix"], args.seed)
    rows_per_call = min(traffic.rows, 4) if cpu else traffic.rows
    draw = lambda k: {n: v[:rows_per_call] for n, v in traffic.call(k).items()}
    use_model = doc["use_model"]
    sim_ms = float(next(c for c in doc["components"] if c["name"] == "Thruster")["simulation"]["duration"]) * 1e3
    thruster = system["Thruster"]
    sync = (lambda: torch.cuda.synchronize(device)) if not cpu else (lambda: None)
    compared = check.COMPARED

    system.predict(draw(-1), use_model=use_model)  # warm-up: builds or loads the kernels
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
    calls, thrust, kept, failed = [], [], None, 0
    checked = CheckDraw(args.seed)
    cost = lambda: sum(t for _, t in thruster.model_costs.values())
    with span(trace.WINDOW):
        t_w0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t_w0 < args.seconds:
            rows = draw(k)
            c0, l0 = cost(), _kernels.launch_counts["kstep"]
            t_a = time.perf_counter()
            try:
                with span(trace.CALL):
                    out = system.predict(rows, use_model=use_model)
                    sync()
                ok = True
            except Exception:  # a call that raises has failed; the loop goes on
                traceback.print_exc()
                out, ok, failed = {}, False, failed + 1
                sync()
            t_b = time.perf_counter()
            calls.append({"k": k, "ok": ok, "rows": rows_per_call, "sim_ms": sim_ms, "wall_s": t_b - t_a,
                          "end": t_b, "thruster_s": cost() - c0, "launches": _kernels.launch_counts["kstep"] - l0})
            if ok:
                thrust.append(out["T"])
                if checked.offer():
                    kept = (k, {n: out[n] for n in compared})
            del out
            k += 1
    t_w1 = calls[-1]["end"]
    peak = int(torch.cuda.max_memory_allocated(device)) if not cpu else 0

    ctx = {"calls": calls, "setup_s": setup_s, "window_wall_s": t_w1 - t_w0}
    dev_name = torch.cuda.get_device_name(device) if not cpu else "cpu"
    if prof is not None:
        prof.stop()
        traced = trace.read(prof, KERNEL)
        del prof
        ctx.update(window_s=traced.get("window_s"), busy_s=traced.get("busy_s"))
        for c, ks in zip(calls, traced.get("kernel_s", [])):
            c["kernel_s"] = ks
        for c in calls:
            c["least_s"] = work.least_seconds(doc["work"], c["rows"],
                                              reference.grid_for(doc, draw(c["k"]), use_model), dev_name)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the check, once the window has closed and the peak is read
    numbers = {n: float("nan") for n in check.NUMBERS}
    nonfinite = [float(1.0 - torch.isfinite(t).float().mean()) for t in thrust]
    if kept is not None:
        pick, outputs = kept
        rows = draw(pick)
        sample = checked.sample(rows_per_call, limits)
        got = {n: torch.as_tensor(outputs[n]).detach().to("cpu", torch.float64).numpy()[sample] for n in compared}
        del kept, outputs, thrust
        if not cpu:
            torch.cuda.empty_cache()
        t_r = time.perf_counter()
        ref = reference.predict(doc, {n: v[sample] for n, v in rows.items()}, use_model, torch.float32,
                                device, batch=rows)
        ref_s = time.perf_counter() - t_r
        numbers = check.readings(got, ref, limits["trace_points"])
    else:
        pick, sample, ref_s = None, [], 0.0
    correct, checks = check.judge(numbers, limits["limits"])
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
        "rows_per_call": rows_per_call, "window_wall_s": ctx["window_wall_s"],
        "kstep_launches_per_call": [min(c["launches"] for c in calls), max(c["launches"] for c in calls)],
        "nonfinite_share_per_call": [min(nonfinite), sum(nonfinite) / len(nonfinite), max(nonfinite)] if nonfinite else None,
        "setup_stages_s": stages,
        "checked_call": pick, "checked_rows": len(sample), "reference_s": ref_s,
        "widest_row_gap": numbers.get("widest"),
        "card": card_line() if not cpu else None,
        "kernel_build": {n: {"seconds": b.get("seconds"), "cached": b.get("cached")}
                         for n, b in _kernels.build_info.items()}}
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
