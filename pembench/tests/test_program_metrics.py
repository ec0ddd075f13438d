"""CPU tests of the per-layer metrics that read the program's own record of
its spans and counters (:mod:`pembench.program`, ``hallthrusterpem_tpu_torch.tracing``)
and of ``pembench/idle_split.py``: the traced dry run of each cell reports the
cell's metrics, a program without the record gives the line without them, and
the interval arithmetic on synthetic spans and events.

    python -m pytest pembench/tests
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from pembench import idle_split, program, run, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
_CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in SPEC["configs"]}
#: the cells whose configuration runs the true model's ``System.predict``, which
#: opens the spans that these metrics read
CELLS = sorted(w["name"] for w in SPEC["workloads"]
               if _CONFIGS[w["config"]].get("operation", run.DEFAULT_OPERATION) == "predict")
#: the per-layer metrics that read the program's record
PROGRAM_METRICS = ("system_host_ms", "thruster_host_ms", "launch_host_us", "rows_masked_pct")


def _program_metrics(cell: str) -> set:
    return {m["name"] for m in run.cell_metrics(SPEC, cell, True)
            if m["name"].split(".")[0] in PROGRAM_METRICS}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_dry_run_reports_the_program_metrics_of_the_cell(cell):
    out = subprocess.run([sys.executable, str(ROOT / "pembench" / "idle_split.py"), "--workload", cell,
                          "--seed", str(2**31 + 23), "--seconds", "0.5", "--trace", "1", "--device", "cpu"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line, split = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    expected = _program_metrics(cell)
    assert {"system_host_ms", "thruster_host_ms"} <= {n.split(".")[0] for n in expected}
    assert expected <= set(line["metrics"]), (expected, list(line["metrics"]))
    value = lambda name: next(v["value"] for n, v in line["metrics"].items() if n.split(".")[0] == name)
    assert all(line["metrics"][n]["value"] >= 0 for n in expected)
    assert 0 < value("system_host_ms") <= value("system_glue_ms")
    device = line["device"]
    idle = device["window_s"] - device["busy_s"]
    assert sum(split["idle_split_s"].values()) == pytest.approx(idle, rel=1e-9)
    assert split["idle_split_s"]["launch_loops"] > 0 and split["program_events_on_card"] == 0


def test_a_program_without_the_record_gives_the_line_without_its_metrics(capsys, monkeypatch):
    """As the parent commit runs: no ``hallthrusterpem_tpu_torch.tracing`` to
    find and no span opened; the run prints the line, every other metric and
    breakdown key in it, and none of the program's metrics."""
    # the program, loaded before the module is hidden
    import hallthrusterpem_tpu_torch.core.json_loader  # noqa: F401
    import hallthrusterpem_tpu_torch.models.cathode  # noqa: F401
    import hallthrusterpem_tpu_torch.models.plume  # noqa: F401
    import hallthrusterpem_tpu_torch.models.thruster._kernels  # noqa: F401
    from hallthrusterpem_tpu_torch import tracing

    monkeypatch.setitem(sys.modules, program.MODULE, None)
    monkeypatch.setattr(tracing, "_autograd_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
    assert run.main(["--workload", "a22_mcmc_eval", "--seed", "29", "--seconds", "0.2", "--trace", "1",
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert not {n.split(".")[0] for n in line["metrics"]} & set(PROGRAM_METRICS)
    assert {"system_glue_ms.eval", "device_idle_pct.eval"} <= set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _ctx(monkeypatch, spans: list) -> dict:
    """Two calls timed by the harness, 10-50 us and 60-100 us, the second
    failed, and the program's record of ``spans``."""
    monkeypatch.setitem(sys.modules, program.MODULE, types.SimpleNamespace(spans=spans))
    return {"calls": [{"ok": True, "end": 50e-6, "wall_s": 40e-6},
                      {"ok": False, "end": 100e-6, "wall_s": 40e-6}]}


def test_spans_are_put_against_the_calls_that_hold_them(monkeypatch):
    us = 1000
    counted = {"kstep_blocks": 3, "kstep_host_ns": 90, "rows_attempted": 4, "rows_masked": 1}
    first = [("htpem.predict", 11 * us, 49 * us, counted), ("htpem.call_model.Thruster", 12 * us, 45 * us, {}),
             ("htpem.thruster.launches", 14 * us, 30 * us, {}),
             ("htpem.wait.finalize", 30 * us, 40 * us, {}), ("htpem.wait.call_model", 43 * us, 47 * us, {})]
    failed = [("htpem.predict", 61 * us, 99 * us, {"kstep_blocks": 7, "rows_attempted": 4})]
    ctx = _ctx(monkeypatch, failed + first + [("htpem.predict", 200 * us, 210 * us, {})])
    calls = program.call_spans(ctx)
    assert calls == [sorted(first, key=lambda s: s[1])]
    # the Thruster 12-45 us, less its launch loop 14-30 and its waits 30-40 and 43-45
    assert program.host_outside(calls[0], program.THRUSTER, program.LAUNCHES, program.WAIT) == 5 * us
    # predict 11-49 us, less the Thruster and the wait, 12-47
    assert program.host_outside(calls[0], program.PREDICT, program.THRUSTER, program.WAIT) == 3 * us
    assert program.counted(calls, "kstep_blocks") == 3 and program.counted(calls, "rows_masked") == 1
    # another outer span: the calls that hold one
    assert program.call_spans(ctx, program.LAUNCHES) == calls
    assert program.call_spans(ctx, "htpem.mlp.forward") is None
    for name, value in (("system_host_ms", 3e-3), ("thruster_host_ms", 5e-3), ("launch_host_us", 0.03),
                        ("rows_masked_pct", 25.0)):
        assert run.reader(name).read(ctx) == pytest.approx(value)


def test_no_record_reads_none(monkeypatch):
    ctx = _ctx(monkeypatch, [])
    monkeypatch.setitem(sys.modules, program.MODULE, None)
    assert program.call_spans(ctx) is None
    for name in PROGRAM_METRICS:
        assert run.reader(name).read(ctx) is None


def test_trace_times_the_kernels_that_the_operation_names(monkeypatch):
    """Each call's time in the card's kernels whose name holds one of the
    operation's substrings: one, as the pem_v0 cells give it, or several."""
    us = 1000
    ev = [(trace.WINDOW, False, 0, 100 * us), (trace.CALL, False, 5 * us, 45 * us),
          (trace.CALL, False, 50 * us, 95 * us), ("void kstep_kernel<3, 1, 224>", True, 10 * us, 20 * us),
          ("sm90_xmma_gemm_f32f32_f32_tn_n", True, 25 * us, 30 * us),
          ("ampere_sgemm_128x64_nn", True, 60 * us, 70 * us), ("elementwise_kernel", True, 72 * us, 73 * us),
          ("cutlass_80_simt_sgemm_64x64_8x5_nn_align1", True, 80 * us, 84 * us)]
    monkeypatch.setattr(trace, "_events", lambda prof: ev)
    assert trace.read(None, ("kstep_kernel",))["kernel_s"] == pytest.approx([10e-6, 0.0])
    got = trace.read(None, ("gemm",))
    assert got["kernel_s"] == pytest.approx([5e-6, 14e-6]) and got["busy_s"] == pytest.approx(30e-6)
    assert trace.read(None, ("kstep_kernel", "xmma"))["kernel_s"] == pytest.approx([15e-6, 0.0])


def test_idle_split_adds_up_to_the_idle_time():
    """A window of two calls, kernels on the card, the harness's annotations
    copied onto the card's timeline: the split adds up to the window less the
    busy time that ``trace.read`` counts, and the loop's idle is where the card
    waited inside it."""
    us = 1000
    ev = [(trace.WINDOW, False, 0, 100 * us), (trace.CALL, False, 5 * us, 45 * us),
          (trace.CALL, False, 50 * us, 95 * us), (trace.CALL, True, 10 * us, 44 * us),
          ("void kstep_kernel<3, 1>", True, 10 * us, 20 * us),
          ("void kstep_kernel<3, 1>", True, 25 * us, 30 * us),
          ("elementwise", True, 32 * us, 33 * us), ("void kstep_kernel<3, 1>", True, 60 * us, 80 * us)]
    for c0 in (5 * us, 50 * us):
        for name, a, b in (("htpem.predict", 1, 39), ("htpem.thruster.launches", 4, 26)):
            ev.append((name, False, c0 + a * us, c0 + b * us))
    got = idle_split.idle_split(ev)
    split = got["idle_split_s"]
    busy = 36e-6
    assert sum(split.values()) == pytest.approx(100e-6 - busy)
    # loops 9-31 us (idle 9-10, 20-25, 30-31) and 54-76 us (idle 54-60)
    assert split["launch_loops"] == pytest.approx(13e-6) and got["launch_idle_ms"] == pytest.approx(6.5e-3)
    # the spans 6-44 and 51-89 less the loops: idle 6-9, 31-32, 33-44, 51-54, 80-89
    assert split["other_program_spans"] == pytest.approx(27e-6)
    assert got["program_events_on_card"] == 0
