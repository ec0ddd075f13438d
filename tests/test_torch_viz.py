"""Port against the JAX package: the plots (``hallthrusterpem_tpu_torch/viz.py``).

Every entry point renders and saves headless, as ``tests/test_viz.py`` checks
for the JAX package; the line data ``plot_slice`` draws on the fake PEM (a JSON
copy of ``tests/fake_pem.yml``) equals JAX's within 1e-6 relative."""

import json
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu import viz as jviz
from hallthrusterpem_tpu.core.yaml_loader import YamlLoader
from hallthrusterpem_tpu_torch.core.json_loader import load_system
from hallthrusterpem_tpu_torch.viz import ax_default, ndscatter, plot_allocation, plot_error_vs_cost, plot_slice
from test_torch_system import yaml_as_json_doc

FAKE = Path(__file__).parent / "fake_pem.yml"


def _fake_system(tmp_path):
    path = tmp_path / "fake_pem.json"
    path.write_text(json.dumps(yaml_as_json_doc(FAKE)))
    return load_system(path, device="cpu")


def test_plot_slice_and_allocation(tmp_path):
    system = _fake_system(tmp_path)
    kw = dict(inputs=["P_b", "V_a"], outputs=["T", "I_d"], num_steps=5)
    fig, axes = plot_slice(system, save_path=tmp_path / "slice.png", **kw)
    assert (tmp_path / "slice.png").exists()
    _, ref_axes = jviz.plot_slice(YamlLoader.load(FAKE), **kw)
    assert axes.shape == ref_axes.shape == (2, 2)
    for ax, ref in zip(axes.ravel(), ref_axes.ravel()):
        assert len(ax.lines) == len(ref.lines) > 0 and ax.get_xlabel() == ref.get_xlabel()
        for line, ref_line in zip(ax.lines, ref.lines):
            np.testing.assert_array_equal(line.get_xdata(), ref_line.get_xdata())
            np.testing.assert_allclose(line.get_ydata(), ref_line.get_ydata(), rtol=1e-6)
    system.predict(system.sample_inputs(4, seed=0), use_model="best")
    fig, ax = plot_allocation(system, save_path=tmp_path / "alloc.png")
    assert (tmp_path / "alloc.png").exists()
    assert system.plot_slice(**kw)[1].shape == (2, 2)
    assert system.plot_allocation()[1].get_xlabel() == "model cost (s)"


def test_error_vs_cost_and_corner(tmp_path):
    history = [
        {"num_evals": 2, "test_error": {"T": 0.5, "I_d": 0.6}},
        {"num_evals": 4, "test_error": {"T": 0.2, "I_d": 0.3}},
        {"num_evals": 8, "test_error": {"T": 0.1, "I_d": 0.15}},
    ]
    plot_error_vs_cost(history, save_path=tmp_path / "err.png")
    assert (tmp_path / "err.png").exists()

    rng = np.random.default_rng(0)
    ndscatter(rng.normal(size=(200, 3)), labels=["a", "b", "c"], save_path=tmp_path / "corner.png")
    assert (tmp_path / "corner.png").exists()

    ax = ax_default(xlabel="x", ylabel="y")
    assert ax.get_xlabel() == "x"
