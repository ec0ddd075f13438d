"""Port against the JAX package: the system-level MLP-ensemble surrogate
(``surrogate/mlp.py``), its training data and saved state, and the failure
classifier (``surrogate/domain.py``).

The same numpy inputs go to both packages. Trained weights cannot be compared
across packages (``torch.Generator`` does not reproduce ``jax.random``), so the
training is held step for step: one and five optimizer steps from the same
parameters on the same minibatches. Tolerances (float32 on both sides): the
ensemble forward within 1e-6 of the output's scale; the r5 trained surrogate's
predictions and the optimizer steps within 1e-5 of each output's (parameter's)
scale; packing, caches, saved state and the classifier, equal.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hallthrusterpem_tpu.core import yaml_loader as jyaml
from hallthrusterpem_tpu.surrogate import domain as jdomain
from hallthrusterpem_tpu.surrogate import mlp as jmlp
from hallthrusterpem_tpu_torch.core.json_loader import load_state, load_system
from hallthrusterpem_tpu_torch.surrogate import domain as tdomain
from hallthrusterpem_tpu_torch.surrogate import mlp as tmlp
from test_torch_system import ROOT, yaml_as_json_doc

torch.set_num_threads(2)
R5 = ROOT / "runs" / "r5" / "surr"
FAKE_YML = ROOT / "tests" / "fake_pem.yml"


def _scaled(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _port_system(tmp_path, yml, name="system.json"):
    path = tmp_path / name
    path.write_text(json.dumps(yaml_as_json_doc(yml)))
    return load_system(path, device="cpu")


def _jax_system(tmp_path, yml, name="system.yml"):
    path = tmp_path / name
    path.write_text(Path(yml).read_text())
    return jyaml.load_system(path)


def _uniform_inputs(system, n, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for v in system.inputs():
        lo, hi = v.get_domain()
        out[v.name] = rng.uniform(lo, hi, n)
    return out


def _params(sizes, members, seed) -> list:
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((members, a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
             (0.1 * rng.standard_normal((members, 1, b))).astype(np.float32))
            for a, b in zip(sizes[:-1], sizes[1:])]


def test_ensemble_forward_matches_jax():
    """``EnsembleMLP`` against ``jax.vmap(mlp._net_forward)`` on the same random
    weights, for a shared input and for member-specific inputs."""
    params = _params([5, 16, 16, 7], members=3, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((33, 5)).astype(np.float32)
    xk = rng.standard_normal((3, 9, 5)).astype(np.float32)
    jp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    net = tmlp.EnsembleMLP(params)
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
        got_k = net(torch.as_tensor(xk)).numpy()
    ref = np.asarray(jax.vmap(jmlp._net_forward, in_axes=(0, None))(jp, jnp.asarray(x)))
    ref_k = np.asarray(jax.vmap(jmlp._net_forward, in_axes=(0, 0))(jp, jnp.asarray(xk)))
    assert got.shape == ref.shape == (3, 33, 7)
    assert _scaled(got, ref) < 1e-6 and _scaled(got_k, ref_k) < 1e-6


def test_r5_trained_surrogate_matches_jax(tmp_path):
    """The r5 campaign's trained ensemble (4 x 512, 8 members, 21 inputs, 35
    outputs + the failure logit), saved by the JAX package, loaded by the port
    through ``load_state``: every output of ``System.predict`` on 256 samples
    from ``default_rng(0)`` within 1e-5 of its scale, ``sys_fail_prob`` included."""
    tsys = _port_system(tmp_path, R5 / "pem_v0_SPT-100_trained.yml")
    load_state(tsys, R5 / "pem_v0_SPT-100_trained.yml.state.pkl")
    assert tsys.system_surrogate.hidden == (512,) * 4 and tsys.system_surrogate.ensemble == 8
    jsys = jyaml.load_system(R5 / "pem_v0_SPT-100_trained.yml")
    x = _uniform_inputs(jsys, 256)
    ref = jsys.predict(x)
    got = tsys.predict(x)
    outs = [k for k in ref if k not in x]
    assert set(outs) == {k for k in got if k not in x} and "sys_fail_prob" in outs
    for k in outs:
        assert got[k].shape == np.shape(ref[k]), k
        assert _scaled(got[k].numpy(), ref[k]) < 1e-5, k


def _jax_loss(cls_weight):
    fwd = jax.vmap(jmlp._net_forward, in_axes=(0, 0))

    def loss_fn(p, xb, yb, mb, fb):  # the loss of mlp.MLPSurrogate.fit
        out = fwd(p, xb)
        pred, logit = out[..., :-1], out[..., -1]
        mse = jnp.sum(mb * (pred - yb) ** 2) / jnp.maximum(jnp.sum(mb), 1.0)
        bce = jnp.mean(optax.sigmoid_binary_cross_entropy(logit, fb))
        return mse + cls_weight * bce

    return loss_fn


@pytest.mark.parametrize("n_steps", [1, 5])
def test_train_step_matches_optax(n_steps):
    """``train_step`` (AdamW, cosine schedule) against
    ``optax.adamw(optax.cosine_decay_schedule(lr, steps, alpha=0.02))`` on JAX's
    loss built from ``mlp._net_forward``: the same parameters and minibatches,
    masked elements and failure labels; each step's loss and the parameters
    after the last within 1e-5 of their scale."""
    K, b, D, P, lr, wd, cls_weight, total = 2, 12, 4, 3, 2e-3, 1e-5, 0.2, 8
    params = _params([D, 8, 8, P + 1], members=K, seed=3)
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((K, b, D)).astype(np.float32),
                rng.standard_normal((K, b, P)).astype(np.float32),
                (rng.uniform(size=(K, b, P)) > 0.2).astype(np.float32),
                (rng.uniform(size=(K, b)) > 0.7).astype(np.float32)) for _ in range(n_steps)]

    opt = optax.adamw(optax.cosine_decay_schedule(lr, total, alpha=0.02), weight_decay=wd)
    jp = [(jnp.asarray(w), jnp.asarray(bb)) for w, bb in params]
    state = opt.init(jp)
    grad = jax.jit(jax.value_and_grad(_jax_loss(cls_weight)))
    ref_losses = []
    for xb, yb, mb, fb in batches:
        loss, g = grad(jp, xb, yb, mb, fb)
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        ref_losses.append(float(loss))

    net = tmlp.EnsembleMLP(params)
    opt_state = tmlp.make_optimizer(net, lr, total, wd)
    losses = [float(tmlp.train_step(net, opt_state, *map(torch.as_tensor, batch), cls_weight)[0])
              for batch in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for (w, bb), (rw, rb) in zip(net.to_numpy(), jp):
        assert _scaled(w, rw) < 1e-5 and _scaled(bb, rb) < 1e-5
    # the parameters moved: the comparison is not of the initial values
    assert _scaled(net.to_numpy()[0][0], params[0][0]) > 1e-4


def _fake_outputs(n, seed=5) -> dict:
    """Outputs of the fake system's shapes: wide-range positive scalars (log
    targets), narrow ones, a non-positive and a NaN value, fields with grids."""
    rng = np.random.default_rng(seed)
    out = {"V_cc": rng.uniform(10, 40, n), "I_B0": rng.uniform(0.5, 9, n), "T": 10 ** rng.uniform(-3, -1, n),
           "I_d": rng.uniform(4.0, 5.0, n), "div_angle": rng.uniform(0.2, 0.5, n),
           "u_ion": rng.uniform(1e3, 2e4, (n, 100)), "u_ion_coords": np.broadcast_to(np.linspace(0, 0.08, 100), (n, 100)),
           "j_ion": 10 ** rng.uniform(-2, 2, (n, 91))}
    out["T"][3] = -1e-3
    out["I_B0"][5] = np.nan
    return out


@pytest.mark.parametrize("regrid", [False, True])
def test_pack_outputs_matches_jax(tmp_path, regrid):
    """``pack_outputs`` and the log-target detection on the fake system, with
    ``u_ion`` compressed (the same projection in both) and ``j_ion`` raw; with
    ``regrid`` the compression grid differs from the model's and the field is
    interpolated onto it (float32 in both packages, so within 1e-6 there; equal
    otherwise)."""
    out = _fake_outputs(40)
    rng = np.random.default_rng(6)
    n_grid = 50 if regrid else 100
    proj, _ = np.linalg.qr(rng.standard_normal((n_grid, 4)))
    jsys, tsys = _jax_system(tmp_path, FAKE_YML), _port_system(tmp_path, FAKE_YML)
    for system in (jsys, tsys):
        c = system["Thruster"]["u_ion"].compression
        c.projection, c.rank = proj, 4
        c.coords = np.linspace(0, 0.08, n_grid) if regrid else None
    surrs = [jmlp.MLPSurrogate(jsys), tmlp.MLPSurrogate(tsys)]
    ref, got = (s.pack_outputs(out) for s in surrs)
    assert surrs[1].log_names == surrs[0].log_names == {"I_B0"}
    assert [(v.name, a, n, k) for v, a, n, k in surrs[1].out_slices] == [
        (v.name, a, n, k) for v, a, n, k in surrs[0].out_slices]
    assert got.shape == ref.shape and np.array_equal(np.isnan(got), np.isnan(ref))
    if regrid:
        assert _scaled(np.nan_to_num(got), np.nan_to_num(ref)) < 1e-6
    else:
        np.testing.assert_array_equal(got, ref)
    x = _uniform_inputs(surrs[0].system, 40)
    np.testing.assert_array_equal(surrs[1].pack_inputs(x), surrs[0].pack_inputs(x))


def test_training_caches_cross_read(tmp_path):
    """``generate_training_data`` caches written by either package are read by
    the other's ``load_training_caches`` as by its own; a port run resumes from
    its cache; the cache holds numpy arrays, the inputs among them."""
    tsys = _port_system(tmp_path, FAKE_YML)
    jsys = _jax_system(tmp_path, FAKE_YML)
    tdir, jdir, mixed = tmp_path / "t", tmp_path / "j", tmp_path / "mixed"
    for d in (tdir, jdir, mixed):
        d.mkdir()
    t_samples, t_out = tmlp.generate_training_data(tsys, 24, seed=1, chunk=10,
                                                   cache_path=tdir / "fake-pem_mlp_train_data_s1.pkl")
    jmlp.generate_training_data(jsys, 16, seed=2, chunk=8, cache_path=jdir / "fake-pem_mlp_train_data_s2.pkl")
    cache = np.load(tdir / "fake-pem_mlp_train_data_s1.pkl", allow_pickle=True)
    assert cache["done"] == 24 and all(isinstance(v, np.ndarray) for v in cache["outputs"].values())
    assert set(t_samples) <= set(cache["outputs"]) and "T" in cache["outputs"]
    np.testing.assert_array_equal(cache["outputs"]["T"], t_out["T"])
    for name in ("fake-pem_mlp_train_data_s1.pkl",):
        (mixed / name).write_bytes((tdir / name).read_bytes())
    (mixed / "fake-pem_mlp_train_data_s2.pkl").write_bytes((jdir / "fake-pem_mlp_train_data_s2.pkl").read_bytes())
    for d, n in ((tdir, 24), (jdir, 16), (mixed, 40)):
        (ts, to), (js, jo) = tmlp.load_training_caches(d, tsys), jmlp.load_training_caches(d, jsys)
        assert set(ts) == set(js) and set(to) == set(jo)
        for a, b in [(ts[k], js[k]) for k in ts] + [(to[k], jo[k]) for k in to]:
            assert a.shape[0] == n
            np.testing.assert_array_equal(a, b)
    # resume: the full cache is reused, and no model runs again
    before = dict(tsys["Thruster"].model_costs)
    again, again_out = tmlp.generate_training_data(tsys, 24, seed=1, chunk=10,
                                                   cache_path=tdir / "fake-pem_mlp_train_data_s1.pkl")
    assert tsys["Thruster"].model_costs == before
    np.testing.assert_array_equal(again_out["T"], t_out["T"])


def _labelled(tmp_path, n=96):
    """A labelled dataset of the fake system: inputs and the JAX system's outputs."""
    jsys = _jax_system(tmp_path, FAKE_YML, "label.yml")
    x = _uniform_inputs(jsys, n, seed=7)
    out = {k: np.asarray(v) for k, v in jsys.predict(x, use_model="best").items()
           if np.asarray(v).dtype.kind == "f" and np.asarray(v).ndim >= 1}
    return x, out


def test_state_roundtrip_both_ways(tmp_path):
    """An MLP surrogate trained and saved by the JAX package loads in the port
    and predicts the same (within 1e-5 of each output's scale); one trained and
    saved by the port loads in the JAX package (``yaml_loader._load_state`` on the
    sidecar) and predicts the same, and reloads in the port bit for bit."""
    x, out = _labelled(tmp_path)
    xq = _uniform_inputs(jyaml.load_system(FAKE_YML), 32, seed=8)
    kw = dict(steps=4, batch=32, verbose=False)

    jsys = _jax_system(tmp_path, FAKE_YML)
    jsys.system_surrogate = jmlp.MLPSurrogate(jsys, hidden=(16, 16), ensemble=2, seed=1)
    jsys.system_surrogate.fit(x, out, **kw)
    jsys.save_to_file("jax_saved.yml", tmp_path)
    tsys = _port_system(tmp_path, FAKE_YML)
    load_state(tsys, tmp_path / "jax_saved.yml.state.pkl")
    ref, got = jsys.predict(xq), tsys.predict(xq)
    for k in ref:
        assert _scaled(got[k].numpy(), ref[k]) < 1e-5, k

    tsys = _port_system(tmp_path, FAKE_YML)
    tsys.system_surrogate = tmlp.MLPSurrogate(tsys, hidden=(16, 16), ensemble=2, seed=1)
    info = tsys.system_surrogate.fit(x, out, **kw)
    assert set(info) >= {"n_train", "n_val", "val_rmse", "val_fail_acc"}
    path = tsys.save_to_file("port_saved.json", tmp_path)
    assert (tmp_path / "port_saved.json.state.pkl").exists()
    jsys = _jax_system(tmp_path, FAKE_YML, "other.yml")
    jyaml._load_state(jsys, tmp_path / "port_saved.json.state.pkl")
    ref, got = tsys.predict(xq), jsys.predict(xq)
    for k in ref:
        assert _scaled(got[k], ref[k].numpy()) < 1e-5, k
    again = load_system(path, device="cpu").predict(xq)
    assert all(torch.equal(again[k], ref[k]) for k in ref)


def test_mlp_fit_and_test_errors(tmp_path):
    """``fit`` on the port: the history and the train/validation split, the
    failure head, ``test_errors`` per output, ``fail_prob`` on the host, a
    reconstructed field; the same seed trains the same weights."""
    x, out = _labelled(tmp_path)
    tsys = _port_system(tmp_path, FAKE_YML)
    c = tsys["Thruster"]["u_ion"].compression
    c.compute_map(np.asarray(tsys["Thruster"]["u_ion"].normalize(out["u_ion"])).T)
    surr = tmlp.MLPSurrogate(tsys, hidden=(16,), ensemble=2, seed=3)
    info = surr.fit(x, out, steps=30, batch=32, log_every=10)
    assert [h["step"] for h in info["history"]] == [0, 10, 20, 29] and info["n_val"] == 9
    errs = surr.test_errors(x, out)
    assert set(errs) == {"V_cc", "I_B0", "T", "I_d", "u_ion", "j_ion", "div_angle"}
    assert all(np.isfinite(v) for v in errs.values())
    p = surr.fail_prob(x)
    assert isinstance(p, np.ndarray) and p.shape == (96,) and np.all((p >= 0) & (p <= 1))
    lat = surr.predict(x)["u_ion"]
    assert surr.reconstruct_field("u_ion", lat).shape == (96, 100)
    twin = tmlp.MLPSurrogate(tsys, hidden=(16,), ensemble=2, seed=3)
    twin.fit(x, out, steps=30, batch=32, verbose=False)
    assert all(np.array_equal(a, b) for pa, pb in zip(twin.net.to_numpy(), surr.net.to_numpy())
               for a, b in zip(pa, pb))


def test_failure_classifier_matches_jax():
    """The r5 domain classifier (saved by the JAX package) in both packages:
    ``prob`` on 512 normalized rows equal, and the keep-mask of a domain filter
    bound to each package's pem_v0 system equal on the same samples."""
    path = R5 / "domain_classifier.pkl"
    jc, tc = jdomain.FailureClassifier.load(path), tdomain.FailureClassifier.load(path)
    rng = np.random.default_rng(0)
    X = jc.x_mu + 2 * jc.x_sd * rng.standard_normal((512, len(jc.var_names)))
    np.testing.assert_array_equal(tc.prob(X), jc.prob(X))
    jsys = jyaml.load_system(ROOT / "scripts" / "pem_v0" / "pem_v0_SPT-100.yml")
    tsys = load_system("pem_v0_SPT-100.json", device="cpu")
    x = _uniform_inputs(jsys, 512, seed=1)
    keep = tdomain.make_domain_filter(tc, tsys)(x)
    np.testing.assert_array_equal(keep, jdomain.make_domain_filter(jc, jsys)(x))
    assert 0 < keep.sum() < 512
    outs = {"T": np.where(np.arange(8) == 2, np.nan, 1.0), "u_ion": np.ones((8, 3)), "u_ion_coords": np.full((8, 3), np.nan)}
    np.testing.assert_array_equal(tdomain.failure_mask(outs), jdomain.failure_mask(outs))
