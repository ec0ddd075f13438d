"""The port's spans and counters (``hallthrusterpem_tpu_torch.tracing``): the
no-op without a profiler, the spans of a ``System.predict`` call of the pem_v0
SPT-100 system under a CPU ``torch.profiler`` run and how they nest, the host
record of the spans beside the profiler's, the K-step counters, and the
masked-row counters on a batch with planted blow-up rows, whose outputs equal
those of the JAX package's wrapper given the same solve."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp
import hallthrusterpem_tpu.models.thruster as jthr
import hallthrusterpem_tpu_torch.models.thruster as tthr
from hallthrusterpem_tpu_torch import cuda_graph, tracing
from hallthrusterpem_tpu_torch.core.json_loader import load_system
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig, make_params

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CONFIG = "pem_v0_SPT-100.json"
#: the spans of one System.predict call of the pem_v0 system on the K-step route, and
#: how often each opens in a call: the input and output trees are made partly in
#: hallthruster_jl and partly in run_simulation, which is an entry of its own
ONCE = ("predict", "call_model.Cathode", "call_model.Thruster", "call_model.Plume", "thruster.solve",
        "thruster.init", "thruster.consts", "thruster.launches", "thruster.average", "thruster.guards")
TWICE = ("thruster.input", "thruster.output")
#: (inner, outer): each span of the first name lies inside one of the second
NESTED = [("thruster.launches", "thruster.solve"), ("thruster.init", "thruster.solve"),
          ("thruster.consts", "thruster.init"),
          ("thruster.average", "thruster.solve"), ("thruster.solve", "call_model.Thruster"),
          ("thruster.input", "call_model.Thruster"), ("thruster.output", "call_model.Thruster"),
          ("thruster.guards", "call_model.Thruster"), ("wait.guards", "thruster.guards"),
          ("wait.finalize", "thruster.average"), ("call_model.Thruster", "predict"),
          ("call_model.Cathode", "predict"), ("call_model.Plume", "predict")]


def _tiny_system():
    """The pem_v0 SPT-100 system on the CPU at the benchmark's dry-run size:
    0.4 us of discharge, averaged from 0.2 us, 20 trace points."""
    system = load_system(CONFIG, device="cpu")
    kw = system["Thruster"].model_kwargs
    kw["simulation"] = dict(kw["simulation"], duration=4e-7, num_save=20)
    kw["postprocess"] = dict(kw["postprocess"], average_start_time=2e-7)
    return system


def _program_spans(prof) -> list:
    """(name without the prefix, start_ns, end_ns) of the program's spans."""
    return sorted(((e.name()[len("htpem."):], e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("htpem.") and e.device_type().name == "CPU"), key=lambda e: e[1])


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"profiler event {name!r} made with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    tracing.spans.clear()
    a, b = tracing.span("predict"), tracing.span("wait.guards")
    assert a is b
    with a, b:
        pass
    assert not tracing.spans


def test_span_under_a_profiler_is_named_htpem_and_kept_with_its_counts():
    """The profiler's host timeline holds ``htpem.probe`` as an operator event,
    not a user annotation (the kind the profiler copies onto the card's
    timeline), and :data:`tracing.spans` holds its host interval on
    ``perf_counter_ns``'s clock with the counters' change over it."""
    import time

    tracing.spans.clear()
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("probe"):
            torch.ones(3).sum()
            tracing.count(rows_attempted=5)
    t1 = time.perf_counter_ns()
    assert [n for n, _, _ in _program_spans(prof)] == ["probe"]
    events = [e for e in prof.events() if e.name == "htpem.probe"]
    assert len(events) == 1 and not events[0].is_user_annotation
    ((name, a, b, counted),) = tracing.spans
    assert name == "htpem.probe" and t0 <= a <= b <= t1 and counted == {"rows_attempted": 5}


def test_spans_of_a_system_call_nest_as_stated():
    system = _tiny_system()
    x = system.sample_inputs(3, seed=1)
    system.predict(x, use_model="best")
    tracing.spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            system.predict(x, use_model="best")
    spans = _program_spans(prof)
    calls = [(s, t) for n, s, t in spans if n == "predict"]
    assert len(calls) == 2
    for c0, c1 in calls:
        inside = [(n, s, t) for n, s, t in spans if c0 <= s and t <= c1]
        names = [n for n, _, _ in inside]
        for name in ONCE:
            assert names.count(name) == 1, (name, names)
        for name in TWICE:
            assert names.count(name) == 2, (name, names)
        assert {n for n in names if n.startswith("wait.")} >= {
            "wait.call_model", "wait._extreme", "wait.finalize", "wait.guards"}
        assert set(names) <= set(ONCE) | set(TWICE) | {n for n in names if n.startswith("wait.")}
        for inner, outer in NESTED:
            for _, s, t in (e for e in inside if e[0] == inner):
                assert any(a <= s and t <= b for n, a, b in inside if n == outer), (inner, outer)
        assert len([n for n in names if n.startswith("call_model.")]) == 3
    assert all(s >= calls[0][0] for _, s, _ in spans)
    # the host record holds the same spans, in the same nesting, with each call's counts
    kept = sorted(tracing.spans, key=lambda s: s[1])
    assert [n[len("htpem."):] for n, _, _, _ in kept] == [n for n, _, _ in spans]
    for n, a, b, counted in kept:
        if n == "htpem.predict":
            assert counted["rows_attempted"] == 3 and counted["kstep_blocks"] > 0


def _carry(B=2, duration=6e-7, num_cells=60):
    cfg = SolverConfig(num_cells=num_cells, ncharge=1, dt=5e-9, duration=duration,
                       average_start_time=duration / 2)
    params = make_params({"V_d": torch.full((B,), 300.0)}, device="cpu")
    base_B = torch.full((cfg.nc,), 0.015)
    return cfg, params, base_B


def test_kstep_counters_count_the_blocks_run(monkeypatch):
    cfg, params, base_B = _carry()
    ran = []
    plain = fs.kstep_plain
    monkeypatch.setattr(fs, "kstep_plain", lambda *args: ran.append(args[4]) or plain(*args))
    tracing.reset_counts()
    out = fs.simulate_batch_multi(params, base_B, cfg)
    assert torch.isfinite(out["thrust"]).all()
    assert len(ran) == math.ceil(cfg.num_steps / fs.INNER_STEPS) == 3
    assert tracing.counts["kstep_blocks"] == len(ran)
    assert tracing.counts["kstep_host_ns"] > 0


@pytest.mark.parametrize("num_cells,lanes", [(60, 128), (200, 224)])
def test_kstep_lanes_counts_the_launched_width(num_cells, lanes):
    """``kstep_lanes / kstep_blocks`` is the lane width the launches ran:
    128 at fidelity (0,0)'s grid and 224 at (2,2)'s."""
    cfg, params, base_B = _carry(num_cells=num_cells, duration=1e-8)
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    tracing.reset_counts()
    for i0 in (0, 1):
        fs.kstep(state, prof, sacc, consts, i0, 1, cfg)
    assert tracing.counts["kstep_blocks"] == 2
    assert tracing.counts["kstep_lanes"] == 2 * lanes == 2 * state.shape[2]


def test_kstep_under_a_capture_is_not_timed():
    cfg, params, base_B = _carry(duration=2e-7)
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    tracing.reset_counts()
    cuda_graph._local.tally = {}
    try:
        fs.kstep(state, prof, sacc, consts, 0, fs.INNER_STEPS, cfg)
    finally:
        cuda_graph._local.tally = None
    assert tracing.counts["kstep_blocks"] == tracing.counts["kstep_host_ns"] == tracing.counts["kstep_lanes"] == 0
    fs.kstep(state, prof, sacc, consts, fs.INNER_STEPS, fs.INNER_STEPS, cfg)
    assert tracing.counts["kstep_blocks"] == 1


def test_planted_blow_up_rows_are_counted_and_masked_as_the_wrapper_masks_them(monkeypatch):
    """Rows 1 and 3 planted with V_d = 3e7 V, mdot_a = 1e-9 kg/s on a 60-cell,
    40-step solve: ``rows_masked`` equals the NaN rows of ``T`` (the planted
    rows), ``rows_attempted`` the batch; the JAX package's wrapper, handed the
    port's solve, gives the same outputs, NaN rows and dtypes."""
    doc = json.loads((ROOT / "hallthrusterpem_tpu_torch" / "configs" / CONFIG).read_text())
    comp = next(c for c in doc["components"] if c["name"] == "Thruster")
    sim = dict(comp["simulation"], adaptive=False, dt=5e-9, duration=2e-7, num_save=0,
               grid={"type": "EvenGrid", "num_cells": 60})
    kw = dict(config=comp["config"], simulation=sim, postprocess=dict(comp["postprocess"], average_start_time=1e-7),
              model_fidelity=None)
    nom = {"P_b": 1e-5, "V_a": 300.0, "mdot_a": 5e-6, "T_e": 1.32721, "u_n": 145.40052, "l_t": 1.87915e-3,
           "a_1": 0.00561226, "a_2": 41.1918, "dz": 0.2, "z0": -0.03104, "p0": 56.86006e-6, "V_cc": 30.0}
    x = {k: np.full(4, v, np.float32) for k, v in nom.items()}
    x["V_a"][[1, 3]], x["mdot_a"][[1, 3]] = 3e7, 1e-9
    solves = []
    solve = tthr.dispatch_solver
    monkeypatch.setattr(tthr, "dispatch_solver", lambda *a, **k: solves.append(solve(*a, **k)) or solves[-1])
    tracing.reset_counts()
    got = tthr.hallthruster_jl({k: torch.as_tensor(v) for k, v in x.items()}, device="cpu", **kw)
    bad = torch.isnan(got["T"])
    assert bad.tolist() == [False, True, False, True]
    assert tracing.counts["rows_attempted"] == 4 and tracing.counts["rows_masked"] == int(bad.sum()) == 2

    raw = {k: jnp.asarray(v.numpy()) for k, v in solves[0].items()}
    monkeypatch.setattr(jthr, "dispatch_solver", lambda p, b, c: raw)
    ref = jthr.hallthruster_jl(x, **kw)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k in ("thruster_output", "model_cost"):
            continue
        g, r = got[k].numpy(), np.asarray(v)
        assert g.dtype == r.dtype == np.float64 and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)
    assert got["model_cost"].dtype == torch.float64 and bool((got["model_cost"] > 0).all())


def test_counts_lose_no_update_across_threads():
    """One host thread per card adds to the counters (``parallel/``): 16
    threads with a short switch interval lose no addition."""
    import sys
    import threading

    tracing.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count(kstep_blocks=1, kstep_host_ns=3)
                                                    for _ in range(2000)]) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert tracing.counts["kstep_blocks"] == 32000 and tracing.counts["kstep_host_ns"] == 96000
