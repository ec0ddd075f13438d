"""The port and chip_smoke.py import without JAX, optax, PyYAML, h5py, pandas,
matplotlib or the JAX package: the machine with the card has none of them. Every
module of the port is imported, the System layer's, the surrogates', the data
loaders', UQ's, the scripts' (the workflow scripts among them), the plots' and
the parallel layer's among them
(scipy is allowed: the card's machine has it)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "optax", "yaml", "h5py", "pandas", "matplotlib", "hallthrusterpem_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import hallthrusterpem_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(proc.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 65
    pkg = "hallthrusterpem_tpu_torch."
    assert {pkg + m for m in ("ops.tridiag", "ops.svd", "models.fake_thruster", "core.dataset", "core.variables",
                              "core.component", "core.system", "core.json_loader", "surrogate",
                              "surrogate.knots", "surrogate.misc", "surrogate.interpolate", "surrogate.component",
                              "surrogate.train", "surrogate.mlp", "surrogate.domain",
                              "data", "data.loader", "uq", "uq.mcmc", "uq.sobol", "uq.montecarlo", "uq.utils",
                              "scripts", "scripts.pem_v0", "scripts.pem_v0.dataset_util", "scripts.pem_v0.mcmc",
                              "scripts.pem_v0.monte_carlo", "scripts.pem_v0.sobol", "scripts.run_mcmc",
                              "scripts.continue_mcmc", "scripts.gen_data", "scripts.fit_surr",
                              "scripts.plot_slice", "scripts.gen_mlp_data", "scripts.trim_domain",
                              "scripts.remask_validity", "scripts.surr_report", "scripts.validate_solver",
                              "scripts.debug", "scripts.install_solver", "viz", "parallel", "parallel.mesh",
                              "parallel.distributed")} <= names
