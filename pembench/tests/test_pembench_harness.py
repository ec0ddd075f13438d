"""CPU tests of the benchmark harness (``pembench/``): the traffic generator,
the frozen work counts, BENCHMARK.json's names, the guard against JAX, the
reference's independence, the harness driven by data files alone, a dry run of
every cell, and the check failing under the control and under faults planted
in the timed path.

    python -m pytest pembench/tests          # here, on the CPU
    python -m pytest -m gpu pembench/tests   # on the card

Every run here is the dry run at a tiny size (``--device cpu``): 0.4 us of
discharge, 4 rows a call, 20 trace points.
"""

from __future__ import annotations

import ast
import functools
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "pembench"
sys.path.insert(0, str(ROOT))

from pembench import check, run, traffic, work  # noqa: E402
from pembench.reference import pem_v0  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in SPEC["configs"]}
CELLS = {w["name"]: w for w in SPEC["workloads"]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: the configurations and cells that run the true model's ``System.predict``
#: (the operation ``predict``), which the pem_v0 tests below read
PREDICT_CONFIGS = sorted(c for c, doc in CONFIGS.items()
                         if doc.get("operation", run.DEFAULT_OPERATION) == "predict")
PREDICT_CELLS = sorted(w for w in CELLS if CELLS[w]["config"] in PREDICT_CONFIGS)


def _operation(cell: str):
    """The class ``Operation`` of the operation that the cell's configuration names."""
    return run.load_cell(cell)["operation"].Operation


def _cell_traffic(cell: str, seed: int) -> traffic.Traffic:
    w = CELLS[cell]
    return traffic.Traffic(CONFIGS[w["config"]], traffic.load_mix(w["traffic"]), seed)


# ------------------------------------------------------------------------------ traffic
@pytest.mark.parametrize("cell", PREDICT_CELLS)
def test_traffic_is_the_same_for_a_seed_and_has_the_stated_rows(cell):
    seed = 2**31 + 977
    a, b, other = _cell_traffic(cell, seed), _cell_traffic(cell, seed), _cell_traffic(cell, seed + 1)
    inputs = traffic.exogenous_inputs(CONFIGS[CELLS[cell]["config"]])
    for k in (-1, 0, 5):
        call, again = a.call(k), b.call(k)
        assert list(call) == list(inputs)
        for name, values in call.items():
            assert values.dtype == np.float32 and values.shape == (a.rows,), name
            np.testing.assert_array_equal(values, again[name])
            assert np.isfinite(values).all(), name
    assert any(not np.array_equal(a.call(3)[n], other.call(3)[n]) for n in inputs)


@pytest.mark.parametrize("cell", PREDICT_CELLS)
def test_traffic_rows_lie_in_their_domains(cell):
    t = _cell_traffic(cell, 12345)
    inputs = traffic.exogenous_inputs(CONFIGS[CELLS[cell]["config"]])
    call = t.call(2)
    for name, var in inputs.items():
        kind = traffic._parse(var["distribution"])[0] if var.get("distribution") else "uniform"
        if kind == "normal":
            continue  # unbounded
        lo, hi = traffic.domain(var)
        if kind == "relative" and name in t.conditions:  # centred on each condition instead
            rel = traffic._parse(var["distribution"])[1][0] / 100
            base = np.tile(t.conditions[name], t.rows // t.n_cond)
            lo, hi = base * (1 - rel), base * (1 + rel)
        span = np.abs(hi - lo) * 1e-6
        assert np.all(call[name] >= lo - span) and np.all(call[name] <= hi + span), name


def test_predictive_rows_are_every_draw_at_every_condition():
    t = _cell_traffic("a22_predictive", 1)
    call = t.call(0)
    assert t.rows == 64 * 23
    for j, name in enumerate(t.names):
        np.testing.assert_array_equal(call[name].reshape(64, 23), np.repeat(t.draws[:, j:j + 1], 23, 1).astype(np.float32))
    np.testing.assert_array_equal(call["V_a"].reshape(64, 23), np.tile(t.conditions["V_a"], (64, 1)).astype(np.float32))


def test_mcmc_rows_are_one_theta_at_the_23_conditions():
    t = _cell_traffic("a22_mcmc_eval", 99)
    inputs = traffic.exogenous_inputs(CONFIGS["spt100_pem_v0_a22"])
    for k in range(3):
        call = t.call(k)
        assert t.rows == 23
        for name in t.names:
            assert np.unique(call[name]).size == 1, name
            lo, hi = traffic.domain(inputs[name])
            assert lo <= call[name][0] <= hi
        np.testing.assert_array_equal(call["P_b"], t.conditions["P_b"].astype(np.float32))


def test_labelling_rows_are_drawn_as_the_workflow_draws_them():
    """``prior_labelling`` draws as ``surrogate.mlp.generate_training_data`` does,
    ``System.sample_inputs(use_pdf=["calibration", "nuisance"])``: for every
    input the two samples of 8,192 rows agree by the two-sample Kolmogorov-Smirnov
    distance, and the operating inputs span their whole domain."""
    from hallthrusterpem_tpu_torch.core.json_loader import load_system

    config = CELLS["a00_labelling"]["config"]
    system = load_system(ROOT / next(c["file"] for c in SPEC["configs"] if c["name"] == config), device="cpu")
    theirs = {k: v.numpy() for k, v in system.sample_inputs(8192, seed=5, use_pdf=["calibration", "nuisance"]).items()}
    t = _cell_traffic("a00_labelling", 5)
    ours = {k: np.concatenate([t.call(i)[k] for i in range(8)]) for k in t.inputs}
    assert set(ours) == set(theirs)
    for name in ours:
        a, b = np.sort(ours[name]), np.sort(theirs[name])
        grid = np.concatenate([a, b])
        ks = np.max(np.abs(np.searchsorted(a, grid, "right") / a.size - np.searchsorted(b, grid, "right") / b.size))
        assert ks < 0.031, (name, ks)  # the 0.1% critical distance at 8,192 a side
    for name in ("P_b", "V_a", "mdot_a"):
        lo, hi = traffic.domain(t.inputs[name])
        assert ours[name].min() < lo + 0.01 * (hi - lo) and ours[name].max() > hi - 0.01 * (hi - lo), name


# --------------------------------------------------------------------------- work count
@pytest.mark.parametrize("config", PREDICT_CONFIGS)
def test_work_count_matches_the_frozen_count(config):
    doc = CONFIGS[config]
    rows = _cell_traffic(next(w for w in CELLS if CELLS[w]["config"] == config), 4).call(0)
    counted = work.count_config(doc, pem_v0, doc["use_model"], {k: v[:3] for k, v in rows.items()})
    assert counted == doc["work"]


def test_least_time_does_not_depend_on_launches():
    doc = CONFIGS["spt100_pem_v0_a22"]
    rows = _cell_traffic("a22_predictive", 3).call(0)
    g = pem_v0.grid_for(doc, rows, "best")
    least = work.least_seconds(doc["work"], len(rows["V_a"]), g, "NVIDIA H100 80GB HBM3")
    ops = work.call_ops(doc["work"], len(rows["V_a"]), g)
    assert least == pytest.approx(ops / 67e12) and 0.05 < least < 0.5
    assert work.least_seconds(doc["work"], 23, g, "some other card") is None


# ---------------------------------------------------------------------- BENCHMARK.json
def test_benchmark_names_units_and_links():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[key]]
    assert len(names) == len(set(names))
    for name in names + [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")] + [
            r for c in SPEC["configs"] for r in c["reduced"]]:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists(), m["name"]
        assert set(m.get("workloads", [])) <= set(CELLS), m["name"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"]), m["name"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and w["config"] in CONFIGS
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert set(check.load_limits(w["name"])["limits"]) == set(_operation(w["name"]).numbers)
        assert len(run.cell_metrics(SPEC, w["name"], False)) >= 2 and run.cell_metrics(SPEC, w["name"], True)
    for c in SPEC["configs"]:
        assert c["file"].startswith("pembench/") and set(c["reduced"]) == set(CONFIGS[c["name"]]["reduced"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


# --------------------------------------------------------------------------- no JAX
def test_the_guard_tells_the_jax_package_from_the_port(monkeypatch):
    monkeypatch.setitem(sys.modules, "hallthrusterpem_tpu_torch_probe", sys)
    assert "hallthrusterpem_tpu_torch_probe" not in run.forbidden_modules()
    for name in ("hallthrusterpem_tpu", "hallthrusterpem_tpu.models.plume", "jax", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name in run.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


def test_nothing_of_pembench_imports_jax_and_the_reference_nothing_of_the_port():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "hallthrusterpem_tpu"}, path
    for path in [*(BENCH / "reference").glob("*.py"), BENCH / "check.py", BENCH / "traffic.py", BENCH / "work.py"]:
        assert "hallthrusterpem_tpu_torch" not in _imports(path), path
    code = ("import json, sys; sys.path.insert(0, {root!r}); from pembench.reference import pem_v0; "
            "from pembench.operations.predict import tiny; import numpy as np; "
            "doc = tiny(json.load(open({cfg!r}))); "
            "rows = {{v['name']: np.full(2, float(v['nominal']), np.float32) for c in doc['components'] "
            "for v in c['inputs'] if 'nominal' in v}}; "
            "pem_v0.predict(doc, rows, 'worst'); "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'hallthrusterpem_tpu_torch', "
            "'hallthrusterpem_tpu', 'jax'}}))").format(root=str(ROOT), cfg=str(BENCH / "configs" / "spt100_pem_v0_a00.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ------------------------------------------------------------------------ dry runs
def _last_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _dry_run(cell: str, seed: int, trace: int = 0, cwd: Path = ROOT, env=None) -> dict:
    out = subprocess.run([sys.executable, str(cwd / "pembench" / "run.py"), "--workload", cell, "--seed", str(seed),
                          "--seconds", "0.5", "--trace", str(trace), "--device", "cpu"],
                         capture_output=True, text=True, timeout=600, cwd=cwd, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return _last_line(out.stdout)


#: the keys of a dry-run line, the keys of its ``calls`` object that the run
#: itself gives, and those of a ``predict`` cell's ``calls`` (as before operations)
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "dry_run", "calls", "checks"}
RUN_CALLS_KEYS = {"rows_per_call", "window_wall_s", "setup_stages_s", "checked_call", "checked_rows", "reference_s",
                  "card"}
CALLS_KEYS = {"rows_per_call", "window_wall_s", "kstep_launches_per_call", "nonfinite_share_per_call",
              "setup_stages_s", "checked_call", "checked_rows", "reference_s", "widest_row_gap", "card",
              "kernel_build"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_dry_run_prints_a_result_line_of_the_contracts_shape(cell):
    line = _dry_run(cell, 2**31 + 5, trace=0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    expected = {m["name"]: m["unit"] for m in run.cell_metrics(SPEC, cell, False)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == expected
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["device"]["platform"] == "cpu" and "dry_run" in line
    op = _operation(cell)
    assert set(line["checks"]) == set(op.numbers) and list(line["checks"]) == list(check.load_limits(cell)["limits"])
    assert set(line) == LINE_KEYS and set(line["calls"]) == RUN_CALLS_KEYS | set(op.line_keys)
    if cell in PREDICT_CELLS:
        assert set(line["checks"]) == set(check.NUMBERS) and set(line["calls"]) == CALLS_KEYS


def test_traced_dry_run_reads_the_host_layers():
    line = _dry_run("a22_mcmc_eval", 17, trace=1)
    assert set(line) == LINE_KEYS | {"breakdown"} and set(line["calls"]) == CALLS_KEYS
    assert "system_glue_ms.eval" in line["metrics"] and "device_idle_pct.eval" in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_without_a_card_the_run_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "a00_labelling", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "pembench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(tmp_path / "pembench" / "run.py"), "--workload", "a00_labelling",
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_configuration_mix_and_metric_added_as_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "pembench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "pembench").rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    doc = dict(json.loads(json.dumps(CONFIGS["spt100_pem_v0_a00"])), operation="predict_marked")
    (tmp_path / "pembench/configs/spt100_pem_v0_a00_copy.json").write_text(json.dumps(doc))
    (tmp_path / "pembench/operations/predict_marked.py").write_text(
        "from pembench.operations.predict import Operation as Predict, tiny  # noqa: F401\n\n\n"
        "class Operation(Predict):\n"
        "    def line(self, calls, numbers):\n"
        "        return {**super().line(calls, numbers), 'operation': 'predict_marked'}\n")
    (tmp_path / "pembench/traffic/two_nominal_rows.json").write_text(json.dumps({"rows_per_call": 2, "rest": "nominal"}))
    (tmp_path / "pembench/metrics/calls_done.py").write_text("def read(ctx):\n    return float(len(ctx['calls']))\n")
    (tmp_path / "pembench/limits/added_cell.json").write_text((BENCH / "limits/a00_labelling.json").read_text())
    spec["configs"].append(dict(spec["configs"][1], name="spt100_pem_v0_a00_copy",
                                file="pembench/configs/spt100_pem_v0_a00_copy.json"))
    spec["workloads"].append({"name": "added_cell", "config": "spt100_pem_v0_a00_copy", "traffic": "two_nominal_rows",
                              "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["added_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    line = _dry_run("added_cell", 3, cwd=tmp_path, env=env)
    assert line["correct"] is True and line["metrics"]["calls_done"]["value"] == line["attempted"]
    assert line["calls"]["rows_per_call"] == 2 and line["calls"]["operation"] == "predict_marked"
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "pembench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items() if "__pycache__" not in p.parts)


# ------------------------------------------------------------ an operation of its own
MLP_LIMITS = {"sample_rows": 16, "limits": {"output_gap": 1e-5, "nonfinite_mismatch": 0.0}}
#: the cells of the copied tree: the MLP, and the MLP with a fault planted where its output is produced
MLP_CELLS = ("mlp_test", "mlp_test_off")


@pytest.fixture(scope="module")
def mlp_tree(tmp_path_factory) -> Path:
    """A copy of the benchmark to which only files and entries are added, as a
    later configuration would add them: the test-only operation
    ``pembench/tests/mlp_operation.py`` and its reference, its configurations,
    traffic, limits and per-layer reader, and two cells in BENCHMARK.json that
    report the existing ``eval_ms``, ``eval_p90_ms`` and ``solve_mfu_pct.eval``."""
    root = tmp_path_factory.mktemp("mlp")
    bench = root / "pembench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH / "tests" / "mlp_operation.py", bench / "operations" / "mlp_test.py")
    shutil.copy(BENCH / "tests" / "mlp_reference.py", bench / "reference" / "mlp_test.py")
    (bench / "operations" / "mlp_test_off.py").write_text(
        "from pembench.operations.mlp_test import Operation as Sound, tiny  # noqa: F401\n\n\n"
        "class Operation(Sound):\n"
        "    def call(self, x):  # every row's first output 1% off where it is produced\n"
        "        out = super().call(x).clone()\n"
        "        out[:, 0] *= 1.01\n"
        "        return out\n")
    (bench / "metrics" / "mlp_forward_ms.py").write_text(
        "from pembench.operations.mlp_test import read  # noqa: F401\n")
    (bench / "traffic" / "mlp_test.json").write_text(json.dumps({"rows_per_call": 64}))
    spec = json.loads(json.dumps(SPEC))
    for name in MLP_CELLS:
        doc = {"operation": name, "reference": "mlp_test", "reduced": [], "widths": [21, 64, 36],
               "peaks": {"cpu": [1e11, 1e10]}}
        (bench / "configs" / f"{name}.json").write_text(json.dumps(doc))
        (bench / "limits" / f"{name}.json").write_text(json.dumps(MLP_LIMITS))
        spec["configs"].append({"name": name, "source": "https://example.org/mlp", "reduced": [],
                                "file": f"pembench/configs/{name}.json", "why": "a test configuration"})
        spec["workloads"].append({"name": name, "config": name, "traffic": "mlp_test", "chips": 1,
                                  "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("eval_ms", "eval_p90_ms", "solve_mfu_pct.eval"):
            m["workloads"] += list(MLP_CELLS)
    spec["per_layer"].append({"name": "mlp_forward_ms", "unit": "ms", "better": "lower", "source": "program_span",
                              "layer": "MLP", "moves": "eval_ms", "workloads": list(MLP_CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _mlp_run(tree: Path, cell: str, trace: int = 0) -> dict:
    return _dry_run(cell, 2**31 + 41, trace=trace, cwd=tree, env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_an_operation_of_its_own_runs_is_timed_and_is_checked(mlp_tree):
    line = _mlp_run(mlp_tree, "mlp_test")
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 1
    assert set(line["metrics"]) == {"eval_ms", "eval_p90_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(MLP_LIMITS["limits"]) and line["checks"]["output_gap"]["value"] < 1e-6
    assert set(line["calls"]) == RUN_CALLS_KEYS | {"widths"}
    assert line["calls"]["widths"] == [21, 64, 36] and line["calls"]["checked_rows"] == 16


def test_an_operation_of_its_own_is_traced_by_its_own_span(mlp_tree):
    line = _mlp_run(mlp_tree, "mlp_test", trace=1)
    assert line["correct"] is True
    # its outer span is read; the pem_v0 readers of htpem.predict are not the cell's
    assert set(line["metrics"]) == {"mlp_forward_ms", "solve_mfu_pct.eval"}
    assert line["metrics"]["mlp_forward_ms"]["value"] > 0 and line["metrics"]["solve_mfu_pct.eval"]["value"] > 0


def test_a_fault_in_an_operation_of_its_own_fails_its_check(mlp_tree):
    line = _mlp_run(mlp_tree, "mlp_test_off")
    assert line["correct"] is False and line["checks"]["output_gap"]["value"] > 1e-3


@pytest.mark.parametrize("side", ["program", "control"])
def test_the_control_of_an_operation_of_its_own_fails_its_check(mlp_tree, side):
    out = subprocess.run([sys.executable, str(mlp_tree / "pembench" / "control.py"), "--workload", "mlp_test",
                          "--seeds", "5,6", "--side", side, "--device", "cpu"], capture_output=True, text=True,
                         timeout=300, cwd=mlp_tree, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    records = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [r["seed"] for r in records] == [5, 6] and all(r["rows"] == 16 for r in records)
    judged = [check.judge(r["numbers"], MLP_LIMITS["limits"], tuple(MLP_LIMITS["limits"]))[0] for r in records]
    assert judged == [side == "program"] * 2, records


def test_judge_takes_the_numbers_of_the_operation():
    names = ("a", "b")
    assert check.judge({"a": 0.0, "b": 1.0}, {"a": 0.5, "b": 2.0}, names)[0]
    assert not check.judge({"a": 0.0, "b": 3.0}, {"a": 0.5, "b": 2.0}, names)[0]
    # a limits file that leaves out a number the operation computes, names another, or none
    correct, checks = check.judge({"a": 0.0, "b": 1.0}, {"a": 0.5}, names)
    assert not correct and list(checks) == ["a", "b"] and np.isnan(checks["b"]["limit"])
    correct, checks = check.judge({"a": 0.0, "b": 1.0}, {"a": 0.5, "b": 2.0, "c": 1.0}, names)
    assert not correct and np.isnan(checks["c"]["value"])
    assert not check.judge({"a": 0.0, "b": 1.0}, {}, names)[0]
    assert not check.judge({}, {}, ())[0]


# ----------------------------------------------------------------------- the check
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_the_check(cell):
    from pembench import control

    limits, names = check.load_limits(cell)["limits"], _operation(cell).numbers
    for record in control.readings(cell, [2**31 + 11], "control", device="cpu"):
        assert not check.judge(record["numbers"], limits, names)[0], record


def _faulty_run(cell, capsys, monkeypatch, fault) -> dict:
    from hallthrusterpem_tpu_torch.models import plume as plume_mod
    from hallthrusterpem_tpu_torch.models import thruster as thruster_mod
    from hallthrusterpem_tpu_torch.models.thruster import fused_step

    if fault == "state unchanged":
        monkeypatch.setattr(fused_step, "kstep", lambda *args, **kwargs: None)
    elif fault == "half the rows":
        solve = thruster_mod.dispatch_solver

        def half(params, base_B, cfg, **kwargs):
            n = params["V_d"].shape[0]
            out = solve({k: v[: n // 2] for k, v in params.items()}, base_B, cfg, **kwargs)
            mean = lambda v: torch.cat([v, torch.broadcast_to(v.nanmean(0, keepdim=True), (n - n // 2, *v.shape[1:]))])
            return {k: mean(v) if v.ndim and v.shape[0] == n // 2 else v for k, v in out.items()}

        monkeypatch.setattr(thruster_mod, "dispatch_solver", half)
    elif fault == "a row from another":
        model = thruster_mod.hallthruster_jl

        @functools.wraps(model)  # the component passes what the model's signature asks for
        def shifted(inputs, *args, **kwargs):
            out = model(inputs, *args, **kwargs)
            ok = torch.isfinite(out["T"]).nonzero().flatten()
            n, a, b = len(out["T"]), int(ok[0]), int(ok[-1])  # the first row with a discharge, the last
            out = {k: v.clone() if torch.is_tensor(v) else v for k, v in out.items()}
            for v in out.values():
                if torch.is_tensor(v) and v.ndim and v.shape[0] == n:
                    v[a] = v[b]
            return out

        monkeypatch.setattr(thruster_mod, "hallthruster_jl", shifted)
    elif fault == "an answer altered":
        density = plume_mod.current_density

        def altered(inputs, **kwargs):
            out = density(inputs, **kwargs)
            j = out["j_ion"] = out["j_ion"].clone()
            j[int(torch.isfinite(inputs["I_B0"]).nonzero()[0])] *= 1.01  # the first row with a beam
            return out

        monkeypatch.setattr(plume_mod, "current_density", altered)
    assert run.main(["--workload", cell, "--seed", "21", "--seconds", "0.2", "--trace", "0", "--device", "cpu"]) == 0
    return _last_line(capsys.readouterr().out)


@pytest.mark.parametrize("fault", ["state unchanged", "half the rows", "a row from another", "an answer altered"])
def test_a_fault_in_the_timed_path_fails_the_check(fault, capsys, monkeypatch):
    assert _faulty_run("a00_labelling", capsys, monkeypatch, None)["correct"] is True
    assert _faulty_run("a00_labelling", capsys, monkeypatch, fault)["correct"] is False


# ---------------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed", "2147483999",
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = _last_line(out.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line
