"""The port's bench (``hallthrusterpem_tpu_torch.bench``) against the repository's
``bench.py``: the same keys, metric, unit string and baseline constant, read
with ``ast`` from ``bench.py``'s source (importing it would set
``HTPEM_UNROLL`` and ``JAX_COMPILATION_CACHE_DIR`` in this process); the line it
prints on the CPU at a small size, with its value computed from the wall as
``bench.py`` computes it; and the null line with exit code 1 when there is no
CUDA device and no ``--device``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hallthrusterpem_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def _bench_py() -> ast.Module:
    return ast.parse((ROOT / "bench.py").read_text())


def _success_dict(tree) -> ast.Dict:
    """The dict literal of ``bench.py``'s result line (the one whose value is not None)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and [getattr(k, "value", None) for k in node.keys][:1] == ["metric"]:
            value = node.values[[k.value for k in node.keys].index("value")]
            if not (isinstance(value, ast.Constant) and value.value is None):
                return node
    raise AssertionError("bench.py has no result line")


def test_keys_metric_unit_and_baseline_match_bench_py():
    tree = _bench_py()
    line = _success_dict(tree)
    assert [k.value for k in line.keys] == ["metric", "value", "unit", "vs_baseline"]
    assert line.values[0].value == bench.METRIC
    const = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "REFERENCE_SIM_MS_PER_SEC")
    assert eval(compile(ast.Expression(const.value), "bench.py", "eval")) == bench.REFERENCE_SIM_MS_PER_SEC
    unit_expr = compile(ast.Expression(line.values[2]), "bench.py", "eval")
    for batch, fid, dur in ((1024, (2, 2), 5e-4), (4, (0, 0), 2.5e-6), (256, (4, 2), 1e-3)):
        ref = eval(unit_expr, {"batch_i": batch, "fid_i": fid, "dur_i": dur})
        assert bench.unit(batch, fid, dur) == ref
    # the null line's keys, as bench.py prints them when it finds no device
    null = next(n for n in ast.walk(tree) if isinstance(n, ast.Dict) and n is not line
                and [getattr(k, "value", None) for k in n.keys][:1] == ["metric"])
    assert [k.value for k in null.keys] == ["metric", "value", "unit", "vs_baseline"]


def test_line_on_cpu(monkeypatch, capsys):
    """BENCH_BATCH=4 at fidelity (0,0) for ~265 steps on the CPU: one JSON line
    whose value is ``batch / wall * duration * 1e3`` of the lower (patched) wall."""
    duration = 2e-6
    monkeypatch.setenv("BENCH_BATCH", "4")
    monkeypatch.setenv("BENCH_FIDELITY", "0,0")
    monkeypatch.setenv("BENCH_DURATION", str(duration))
    ticks = iter([0.0, 2.5, 10.0, 11.75])  # timed runs of 2.5 s and 1.75 s
    monkeypatch.setattr(bench, "_clock", lambda: next(ticks))
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    wall = 1.75
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "coupled_pem_sim_ms_per_sec_per_chip"
    assert rec["value"] == round(4 / wall * duration * 1e3, 3)
    assert rec["vs_baseline"] == round(4 / wall * duration * 1e3 / (64 * 2 / 30), 2)
    assert rec["unit"] == "sim-ms/s/chip (batch=4, fidelity=(0, 0), 2e-06s sim)"
    assert "4/4 finite" in err and "kstep launches per timed run [0, 0]" in err and "device cpu" in err


def test_null_line_without_a_card():
    """No CUDA device and no --device: bench.py's null line, exit code 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "hallthrusterpem_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "coupled_pem_sim_ms_per_sec_per_chip"
    assert rec["value"] is None and rec["vs_baseline"] is None and "CUDA" in rec["unit"]


def test_run_once_counts_finite_rows_on_cpu():
    r = bench.run_once(3, 2e-7, (0, 0), torch.device("cpu"))
    assert r["n_ok"] == 3 and np.isfinite(r["mean_T"]) and r["kstep_launches"] == [0, 0]
    assert len(r["walls"]) == 2 and r["wall"] == min(r["walls"]) and r["num_steps"] > 0
