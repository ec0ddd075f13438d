"""Port against the JAX package: ``hallthrusterpem_tpu_torch.scripts.mlp_sweep``
(the MLP hyper-parameter sweep), on the CPU.

Both packages run their sweep's ``main`` (JAX's ``scripts/mlp_sweep.py`` by file
path) on one run directory of the fake PEM (``tests/fake_pem.yml``, its JSON copy
for the port): one training-data cache the port's ``generate_training_data``
wrote, which both packages read, and a ``test_set.pkl`` with discarded rows.
Trained weights cannot agree across packages (``torch.Generator`` is not
``jax.random``), so each package's ``fit`` is patched: JAX's trains 3 steps and
keeps its state, the port's loads that state. The variants chosen, their
records (the JSON file but its wall times), the best variant and its saved
state must then agree, each rel-L2 within 1e-6 relative.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from hallthrusterpem_tpu.core import yaml_loader as jyaml
from hallthrusterpem_tpu.surrogate import mlp as jmlp
from hallthrusterpem_tpu_torch.core.json_loader import load_state, load_system
from hallthrusterpem_tpu_torch.scripts import mlp_sweep
from hallthrusterpem_tpu_torch.surrogate import mlp as tmlp
from test_torch_mlp import FAKE_YML, _port_system, _uniform_inputs
from test_torch_studies import _jax_script
from test_torch_system import yaml_as_json_doc

torch.set_num_threads(2)
REL_TOL = 1e-6


def test_constants_match_jax():
    jax_mod = _jax_script("mlp_sweep")
    assert mlp_sweep.VARIANTS == jax_mod.VARIANTS and mlp_sweep.TARGETS == jax_mod.TARGETS
    assert mlp_sweep.SURR_DIR == jax_mod.SURR_DIR


def _run_dir(tmp_path):
    """The fake PEM's run directory: its YAML under the JAX script's fixed name,
    its JSON copy, one port-written training cache and a test set."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "pem_v0_SPT-100_compression.yml").write_text(FAKE_YML.read_text())
    (run / "fake_pem.json").write_text(json.dumps(yaml_as_json_doc(FAKE_YML)))
    tsys = _port_system(tmp_path, FAKE_YML)
    tmlp.generate_training_data(tsys, 80, seed=1, chunk=40, cache_path=run / "fake-pem_mlp_train_data_s1.pkl")
    jsys = jyaml.load_system(FAKE_YML)
    x = _uniform_inputs(jsys, 40, seed=9)
    out = {k: np.asarray(v) for k, v in jsys.predict(x, use_model="best").items()
           if np.asarray(v).dtype.kind == "f" and np.asarray(v).ndim >= 1}
    discard = np.zeros(40, bool)
    discard[[3, 17]] = True
    with open(run / "test_set.pkl", "wb") as fd:
        pickle.dump({"samples": x, "outputs": out, "discard": discard}, fd)
    return run


@pytest.mark.parametrize("variants", [["base6k", "wide512"], ["long20k", "deep384", "wide512_wd1e-4"]])
def test_sweep_matches_jax(variants, tmp_path, monkeypatch):
    """The same variants in the same order, the same records (score inputs,
    spec keys, val_rmse, rel-L2 per target), the same best variant, and the
    saved best: the port's reloads bit for bit and predicts as JAX's saved one."""
    run = _run_dir(tmp_path)
    states, errors = [], {"jax": [], "port": []}
    jfit, jerr, terr = jmlp.MLPSurrogate.fit, jmlp.MLPSurrogate.test_errors, tmlp.MLPSurrogate.test_errors

    def jax_fit(self, samples, outputs, **kw):
        info = jfit(self, samples, outputs, **dict(kw, steps=3, batch=32))
        states.append((self.to_state(), info, kw))
        return info

    def port_fit(self, samples, outputs, **kw):
        state, info, jkw = states[len(errors["port"])]
        assert kw == jkw and state["hidden"] == self.hidden and state["ensemble"] == self.ensemble
        self.__dict__.update(tmlp.MLPSurrogate.from_state(state, self.system).__dict__)
        return info

    monkeypatch.setattr(jmlp.MLPSurrogate, "fit", jax_fit)
    monkeypatch.setattr(tmlp.MLPSurrogate, "fit", port_fit)
    monkeypatch.setattr(jmlp.MLPSurrogate, "test_errors",
                        lambda self, *a, **k: errors["jax"].append(jerr(self, *a, **k)) or errors["jax"][-1])
    monkeypatch.setattr(tmlp.MLPSurrogate, "test_errors",
                        lambda self, *a, **k: errors["port"].append(terr(self, *a, **k)) or errors["port"][-1])
    monkeypatch.chdir(tmp_path)
    _jax_script("mlp_sweep").main(["--dir", str(run), "--variants", *variants, "--save-best"])
    results, (best, surr) = mlp_sweep.main(["--dir", str(run), "--config", "fake_pem.json", "--variants", *variants,
                                            "-o", str(tmp_path / "out" / "sweep.json"), "--save-best",
                                            "--device", "cpu"])

    ref = json.loads((run / "mlp_sweep.json").read_text())
    got = json.loads((tmp_path / "out" / "sweep.json").read_text())
    assert got == json.loads(json.dumps(results))
    assert [r["name"] for r in got] == [r["name"] for r in ref] == variants
    for g, r in zip(got, ref):
        g.pop("wall_s"), r.pop("wall_s")
        assert g.pop("rel_l2").keys() == r.pop("rel_l2").keys()
        assert g == r
    assert len(errors["jax"]) == len(errors["port"]) == len(variants)
    for t, j in zip(errors["port"], errors["jax"]):
        assert t.keys() == j.keys() and {"T", "I_d", "u_ion", "j_ion"} <= set(t)
        for k in j:
            assert abs(t[k] - j[k]) <= REL_TOL * abs(j[k]), (k, t[k], j[k])
    scores = [mlp_sweep.score(e) for e in errors["jax"]]
    assert best == variants[int(np.argmin(scores))]

    xq = _uniform_inputs(jyaml.load_system(FAKE_YML), 16, seed=4)
    mine = surr.predict(xq)
    again = load_system(tmp_path / "out" / "pem_v0_SPT-100_trained.json", device="cpu").predict(xq)
    assert all(torch.equal(again[k], mine[k]) for k in mine)
    from_jax = load_system(run / "fake_pem.json", device="cpu")
    load_state(from_jax, run / "pem_v0_SPT-100_trained.yml.state.pkl")
    theirs = from_jax.predict(xq)
    for k in mine:
        scale = max(float(mine[k].abs().max()), 1e-30)
        assert float((theirs[k] - mine[k]).abs().max()) / scale < 1e-5, k


def test_sweep_without_caches_raises(tmp_path):
    """A run directory with no training cache raises before any fit (the r5
    directory in this repository has none)."""
    run = tmp_path / "empty"
    run.mkdir()
    with pytest.raises(FileNotFoundError, match="no training-data caches"):
        mlp_sweep.main(["--dir", str(run), "--device", "cpu", "-o", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
