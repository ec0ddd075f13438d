"""Port against the JAX package: the sparse-grid (MISC) surrogate engine
(``surrogate/{knots,misc,interpolate,component,train}.py``) and the surrogate
side of ``System`` (``fit``, ``predict(use_model=None)``, ``as_torch_fn``,
``load_training_cache``, ``get_allocation``, saved state).

The shapes of tests/test_surrogate.py, on the same numpy inputs in both packages.
The fits run on a JSON copy of tests/fake_pem.yml with every component's cost
pinned to one second an evaluation: the trainer's greedy choice divides by the
measured cost, a wall-clock time that differs from run to run. Tolerances: knots,
index sets and numpy interpolants equal; the torch ``eval_tensor`` within 1e-12
of the values' scale in float64 and 1e-5 in float32; fits take the same
activations, with indicators within 1e-5 relative and predictions within 1e-5 of
each output's scale (the models compute in float32 in both packages).
"""

import json
import random
from itertools import product
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hallthrusterpem_tpu import surrogate as jsur
from hallthrusterpem_tpu.core import yaml_loader as jyaml
from hallthrusterpem_tpu.surrogate.interpolate import jit_eval_tensor
from hallthrusterpem_tpu_torch import surrogate as tsur
from hallthrusterpem_tpu_torch.core.json_loader import load_state, load_system
from test_torch_system import ROOT, yaml_as_json_doc

torch.set_num_threads(2)
FAKE_YML = ROOT / "tests" / "fake_pem.yml"


def _scaled(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _fixed_cost(system):
    for comp in system.components:
        comp.get_cost = lambda alpha=(), beta=(): 1.0
    return system


def _systems(tmp_path, tag=""):
    """The fake PEM in both packages, ``u_ion`` compressed by the same map and
    the costs pinned: (JAX system, port system)."""
    yml = tmp_path / f"fake{tag}.yml"
    yml.write_text(FAKE_YML.read_text())
    js = (tmp_path / f"fake{tag}.json")
    js.write_text(json.dumps(yaml_as_json_doc(FAKE_YML)))
    jsys, tsys = jyaml.load_system(yml), load_system(js, device="cpu")
    proj, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((100, 3)))
    for system in (jsys, tsys):
        c = system["Thruster"]["u_ion"].compression
        c.projection, c.rank = proj, 3
    return _fixed_cost(jsys), _fixed_cost(tsys)


def _inputs(system, n, seed) -> dict:
    rng = np.random.default_rng(seed)
    return {v.name: rng.uniform(*v.get_domain(), n) for v in system.inputs()}


def _downward_closed(d, n, seed) -> set:
    rng = random.Random(seed)
    s = {(0,) * d}
    for _ in range(n):
        base = rng.choice(sorted(s))
        i = rng.randrange(d)
        cand = base[:i] + (base[i] + 1,) + base[i + 1:]
        if all(cand[:j] + (cand[j] - 1,) + cand[j + 1:] in s for j in range(d) if cand[j] > 0):
            s.add(cand)
    return s


def test_knots_and_weights_match_jax():
    for n in (1, 2, 3, 5, 9, 17):
        np.testing.assert_array_equal(tsur.leja_sequence(n), jsur.leja_sequence(n))
    for level, kpl, dom in product(range(5), (1, 2, 3), ((-1.0, 1.0), (10.0, 20.0), (-7.5, -2.0))):
        k = tsur.knots_for_level(level, kpl, domain=dom)
        np.testing.assert_array_equal(k, jsur.knots_for_level(level, kpl, domain=dom))
        np.testing.assert_array_equal(tsur.barycentric_weights(k), jsur.barycentric_weights(k))


def test_misc_sets_match_jax():
    from hallthrusterpem_tpu.surrogate import misc as jmisc
    from hallthrusterpem_tpu_torch.surrogate import misc as tmisc

    for d, seed in product((2, 3, 5), range(3)):
        s = _downward_closed(d, 20, seed)
        assert tsur.combination_coefficients(s) == jsur.combination_coefficients(s)
        levels = [3] * d
        assert tsur.candidate_neighbors(s, levels) == jsur.candidate_neighbors(s, levels)
        assert tsur.is_downward_closed(s) == jsur.is_downward_closed(s)
        bad = s | {(0,) * (d - 1) + (9,)}  # (0, ..., 8) is missing
        assert tsur.is_downward_closed(bad) == jsur.is_downward_closed(bad)
        assert tmisc.split_index((1, 2, 3), 1) == jmisc.split_index((1, 2, 3), 1)


@pytest.mark.parametrize("method", ["lagrange", "linear"])
def test_interpolant_and_eval_tensor_match_jax(method):
    """Three dims of 5, 3 and 1 knots, two outputs: the numpy interpolant equals
    JAX's; the torch ``eval_tensor`` on the same nodes and weights within 1e-12
    (float64) of JAX's host evaluation and 1e-5 (float32) of its jittable one,
    on random points, points on the knots and points past the domain."""
    knots = (jsur.knots_for_level(2, 2, (-1.0, 1.0)), jsur.knots_for_level(1, 2, (0.0, 2.0)),
             jsur.knots_for_level(0, 2, (3.0, 4.0)))
    rng = np.random.default_rng(0)
    values = rng.standard_normal((5, 3, 1, 2))
    lo, hi = np.array([-1.0, 0.0, 3.0]), np.array([1.0, 2.0, 4.0])
    xq = np.concatenate([rng.uniform(lo, hi, (200, 3)), jsur.tensor_grid_points(knots),
                         rng.uniform(lo - 0.3, hi + 0.3, (40, 3))])
    ji = jsur.TensorInterpolant(knots=knots, values=values, method=method)
    ti = tsur.TensorInterpolant(knots=knots, values=values, method=method)
    ref = np.asarray(ji(xq))
    np.testing.assert_array_equal(ti(xq), ref)
    as64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    got = tsur.eval_tensor([as64(k) for k in ti.knots], [as64(w) for w in ti._weights], as64(ti.values),
                           as64(xq), method=method)
    assert got.dtype == torch.float64 and _scaled(got.numpy(), ref) < 1e-12
    f32 = lambda a: np.asarray(a, np.float32)
    ref32 = np.asarray(jit_eval_tensor(tuple(jnp.asarray(f32(k)) for k in ji.knots),
                                       tuple(jnp.asarray(f32(w)) for w in ji._weights),
                                       jnp.asarray(f32(ji.values)), jnp.asarray(f32(xq)), method=method))
    as32 = lambda a: torch.as_tensor(f32(a))
    got32 = tsur.eval_tensor([as32(k) for k in ti.knots], [as32(w) for w in ti._weights], as32(ti.values),
                             as32(xq), method=method)
    assert got32.dtype == torch.float32 and _scaled(got32.numpy(), ref32) < 1e-5


def _history(system):
    return [(h["component"], tuple(h["alpha"]), tuple(h["beta"]), h["num_evals"]) for h in system.train_history]


def test_fit_system_matches_jax(tmp_path):
    """``fit`` (``fit_system``) on the fake PEM, 4 iterations with a test set:
    the same activations and evaluation counts, the error indicators and test
    errors within 1e-5 relative, and ``predict(use_model=None, training=True)``
    (host numpy) within 1e-5 of each output's scale; ``as_torch_fn`` on the
    port's CPU within 1e-5 of its host ``predict``, and of JAX's ``as_jax_fn``."""
    jsys, tsys = _systems(tmp_path)
    xt = _inputs(jsys, 48, seed=1)
    yt = {k: np.asarray(v) for k, v in jsys.predict(xt, use_model="best").items() if k in ("T", "I_d", "u_ion")}
    kw = dict(max_iter=4, num_refine=32, seed=0, verbose=False, test_set=(xt, yt), targets=["T", "I_d"])
    jhist, thist = jsys.fit(**kw), tsys.fit(**kw)
    assert _history(tsys) == _history(jsys) and len(thist) == 4
    for th, jh in zip(thist, jhist):
        assert abs(th["error_indicator"] - jh["error_indicator"]) <= 1e-5 * abs(jh["error_indicator"])
        assert set(th["test_error"]) == set(jh["test_error"]) == {"T", "I_d"}
        for k, v in jh["test_error"].items():
            assert abs(th["test_error"][k] - v) <= 1e-5 * abs(v), k
    for comp in tsys.components:
        assert comp.surrogate.active == jsys[comp.name].surrogate.active
        assert comp.surrogate.candidates == jsys[comp.name].surrogate.candidates
    x = _inputs(jsys, 64, seed=2)
    ref = jsys.predict(x, use_model=None, training=True)
    got = tsys.predict(x, use_model=None, training=True)
    outs = [k for k in ref if k not in x]
    assert set(outs) == {"V_cc", "I_B0", "T", "I_d", "u_ion", "j_ion", "div_angle"}
    for k in outs:
        assert got[k].shape == np.shape(ref[k]) and _scaled(got[k].numpy(), ref[k]) < 1e-5, k
    dev = tsys.as_torch_fn(training=True)({k: torch.as_tensor(v, dtype=torch.float32) for k, v in x.items()})
    jdev = jsys.as_jax_fn(training=True)({k: jnp.asarray(v, jnp.float32) for k, v in x.items()})
    for k in outs:
        assert dev[k].dtype == torch.float32
        assert _scaled(dev[k].numpy(), got[k].numpy()) < 1e-5, k
        assert _scaled(dev[k].numpy(), jdev[k]) < 1e-5, k
    assert tsys.as_jax_fn == tsys.as_torch_fn


def test_training_cache_and_allocation_match_jax(tmp_path):
    """``fit(cache_interval=1)`` in either package writes a cache the other's
    ``load_training_cache`` merges as its own does: the same point counts and the
    same ``get_allocation``; a port refit from the cache runs fewer model
    evaluations than the first fit did."""
    jsys, tsys = _systems(tmp_path)
    for system, d in ((jsys, tmp_path / "j"), (tsys, tmp_path / "t")):
        system.root_dir = d
        system.fit(max_iter=3, num_refine=16, cache_interval=1, verbose=False)
    n_evals = lambda system: sum(n for c in system.components for n, _ in c.model_costs.values())
    first_evals = n_evals(tsys)
    for d in ("j", "t"):
        cache = tmp_path / d / "cache" / "fake-pem_training_cache.pkl"
        fresh_j, fresh_t = _systems(tmp_path, tag=d)
        n_j, n_t = fresh_j.load_training_cache(cache), fresh_t.load_training_cache(cache)
        assert n_t == n_j > 0
        alloc_j, alloc_t = fresh_j.get_allocation(), fresh_t.get_allocation()
        assert alloc_t == alloc_j and alloc_t[2] == 0.0
        for comp in fresh_t.components:
            jc = fresh_j[comp.name].surrogate
            assert set(comp.surrogate.eval_cache) == set(jc.eval_cache)
            assert comp.surrogate._repaired_keys == getattr(jc, "_repaired_keys", {})
        # a refit from the cache (its "j_ion" uncompressed: JAX's refit fails here)
        restored = n_evals(fresh_t)
        fresh_t.fit(max_iter=3, num_refine=16, verbose=False)
        assert len(fresh_t.train_history) == 3 and n_evals(fresh_t) - restored < first_evals
    cost_alloc, model_cost, overhead, evals = tsys.get_allocation()
    assert set(cost_alloc) == {"Cathode", "Thruster", "Plume"} and overhead > 0 and model_cost > 0


def test_misc_state_roundtrip_both_ways(tmp_path):
    """MISC surrogates saved by the JAX package load in the port (``load_state``
    on its ``.yml.state.pkl``) and the reverse (JAX's ``_load_state`` on the port's
    sidecar): the same active sets and the same host predictions, within 1e-12
    of scale (both float64 numpy); the port's own reload predicts bit for bit."""
    jsys, tsys = _systems(tmp_path)
    kw = dict(max_iter=3, num_refine=16, verbose=False)
    jsys.fit(**kw)
    tsys.fit(**kw)
    x = _inputs(jsys, 32, seed=4)
    jsys.save_to_file("jax_fit.yml", tmp_path)
    path = tsys.save_to_file("port_fit.json", tmp_path)

    other_j, other_t = _systems(tmp_path, tag="2")
    load_state(other_t, tmp_path / "jax_fit.yml.state.pkl")
    jyaml._load_state(other_j, tmp_path / "port_fit.json.state.pkl")
    for loaded, source in ((other_t, jsys), (other_j, tsys)):
        assert loaded.train_history == source.train_history
        for comp in loaded.components:
            assert comp.surrogate.active == source[comp.name].surrogate.active
        got = loaded.predict(x, use_model=None, training=True)
        ref = source.predict(x, use_model=None, training=True)
        for k in ref:
            g, r = (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got[k], ref[k]))
            assert _scaled(g, r) < 1e-12, k
    again = _fixed_cost(load_system(path, device="cpu")).predict(x, use_model=None, training=True)
    ref = tsys.predict(x, use_model=None, training=True)
    assert all(torch.equal(again[k], ref[k]) for k in ref)
    tsys.clear()
    assert tsys.train_history == [] and all(c.surrogate is None for c in tsys.components)
    with pytest.raises(ValueError, match="no trained surrogate"):
        tsys.as_torch_fn()
