"""Port against the JAX package: the multi-device layer (``parallel/mesh.py``,
``parallel/distributed.py``, ``models.thruster.simulate_batch_sharded``).

The port's sharded solve on ``Mesh(["cpu"] * 8)`` is held against JAX's
``simulate_batch_sharded`` (the Pallas K-step kernel in interpret mode under
``shard_map`` on the 8 virtual CPU devices of ``tests/conftest.py``) on
``tests/test_pallas_sharded.py``'s setup: thrust and I_d within 1e-2 relative
(the run-level bound). The solve has no traffic between samples, so the sharded
run is held to the port's own unsharded run within 1e-6 scaled (equal bits are
expected; the CPU's vectorised loops may round a tail element apart). A real
two-process ``gloo`` run gathers the same results on both ranks.
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from hallthrusterpem_tpu.models.thruster import simulate_batch_sharded as jax_sharded
from hallthrusterpem_tpu.models.thruster.config import SolverConfig as JaxSolverConfig
from hallthrusterpem_tpu.models.thruster.config import make_params as jax_make_params
from hallthrusterpem_tpu.parallel.mesh import pad_to_multiple as jax_pad
from hallthrusterpem_tpu_torch.models.thruster import _kernels, dispatch_solver, hallthruster_jl, simulate_batch_sharded
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig
from hallthrusterpem_tpu_torch.parallel import BatchExecutor, Mesh, make_mesh, pad_to_multiple, sharded_call
from hallthrusterpem_tpu_torch.parallel import distributed as dist
from hallthrusterpem_tpu_torch.parallel.mesh import Shards, shard_batch
from hallthrusterpem_tpu_torch.pem import CoupledPEM, default_coupled_inputs

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
CPU8 = Mesh(["cpu"] * 8)
#: a 32-cell, 50-step coupled PEM (the two-process test's size)
SMALL = dict(model_fidelity=(0, 0), config={"ncharge": 1},
             simulation={"num_cells": 32, "dt": 5e-9, "duration": 50 * 5e-9})


def _setup(batch: int, ncharge: int = 1):
    """``tests/test_pallas_sharded.py``'s setup: JAX's config, params and B-field."""
    cfg = JaxSolverConfig(num_cells=32, ncharge=ncharge, dt=5e-9, duration=400 * 5e-9,
                          average_start_time=200 * 5e-9)
    z = cfg.cell_centers()
    s = np.where(z < cfg.geometry.channel_length, 0.011, 0.018)
    base_B = jnp.asarray(0.016 * np.exp(-0.5 * ((z - 0.025) / s) ** 2), jnp.float32)
    rng = np.random.default_rng(3)
    params = jax_make_params({
        "V_d": 300.0 * (1 + 0.05 * rng.standard_normal(batch)),
        "mdot_a": 5e-6 * (1 + 0.05 * rng.standard_normal(batch)),
        "P_b": np.full(batch, 1e-5),
        "u_n": np.full(batch, 150.0),
    })
    return cfg, params, base_B


def _port(cfg, params, base_B):
    tcfg = SolverConfig(num_cells=cfg.num_cells, ncharge=cfg.ncharge, dt=cfg.dt, duration=cfg.duration,
                        average_start_time=cfg.average_start_time)
    tparams, tB = fs.from_jax_numpy({k: np.asarray(v) for k, v in params.items()}, np.asarray(base_B), "cpu")
    return tcfg, tparams, tB


def _scaled(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("arr,multiple", [
    pytest.param(np.arange(5.0), 4, id="float"),
    pytest.param(np.arange(10, dtype=np.int32).reshape(5, 2), 3, id="int"),
    pytest.param(np.linspace(0.0, 1.0, 8), 4, id="multiple"),
])
def test_pad_to_multiple_matches_jax(arr, multiple):
    ref, n_ref = jax_pad(arr, multiple)
    got, n = pad_to_multiple(arr, multiple)
    got_t, n_t = pad_to_multiple(torch.as_tensor(arr), multiple)
    assert n == n_t == n_ref == len(arr)
    assert isinstance(got, np.ndarray) and isinstance(got_t, torch.Tensor)
    assert got.dtype == ref.dtype and got_t.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_t.numpy(), ref)


@pytest.mark.parametrize("batch,ncharge", [pytest.param(16, 1, id="thrust_and_current"),
                                           pytest.param(8, 2, id="profiles_two_charge")])
def test_sharded_matches_jax_and_unsharded(eight_devices, batch, ncharge):
    cfg, params, base_B = _setup(batch, ncharge)
    ref = jax_sharded(params, base_B, cfg, JaxMesh(np.asarray(eight_devices), ("batch",)),
                      backend="pallas", interpret=True)
    tcfg, tparams, tB = _port(cfg, params, base_B)
    got = simulate_batch_sharded(tparams, tB, tcfg, CPU8)
    alone = dispatch_solver(tparams, tB, tcfg)

    assert got["ui"].shape == (batch, ncharge, tcfg.nc) and got["z"].shape == (batch, tcfg.nc)
    assert np.isfinite(got["ui"].numpy()).all() and np.isfinite(got["thrust"].numpy()).all()
    for key in ("thrust", "discharge_current"):
        rel = np.max(np.abs(got[key].numpy() - np.asarray(ref[key])) / np.abs(np.asarray(ref[key])))
        assert rel < 1e-2, (key, rel)
    assert set(got) == set(alone)
    for key in alone:
        assert got[key].shape == alone[key].shape and got[key].dtype == alone[key].dtype, key
        assert _scaled(got[key], alone[key]) <= 1e-6, key


def test_sharded_batch_divisibility():
    tcfg, tparams, tB = _port(*_setup(12))
    with pytest.raises(ValueError, match="divide"):
        simulate_batch_sharded(tparams, tB, tcfg, CPU8)


def test_batch_executor_pads_and_trims():
    pem = CoupledPEM(**SMALL, device="cpu")
    inputs = default_coupled_inputs(12, device="cpu")
    calls = []
    got = BatchExecutor(CPU8).run(lambda x: (calls.append(len(x["V_a"])), pem(x))[1], inputs)
    alone = pem(inputs)
    assert calls == [2] * 8  # padded to 16, two rows a shard
    assert set(got) == set(alone)
    for key, ref in alone.items():
        assert got[key].shape == ref.shape and ref.shape[0] == 12, key
        assert _scaled(got[key], ref) <= 1e-6, key


#: the wrapper's batch-wide config: the largest V_a sets the time step, so each
#: half of this batch alone would step at its own (fidelity (0,0), 2e-6 s)
WRAPPER_INPUTS = {"V_a": [200.0, 250.0, 300.0, 400.0], "mdot_a": [5e-6] * 4, "P_b": [1e-5] * 4,
                  "V_cc": [30.0] * 4}
WRAPPER_KW = dict(model_fidelity=(0, 0), simulation={"duration": 2e-6}, device="cpu")


@pytest.mark.parametrize("rows", [pytest.param(4, id="two_rows_a_shard"),
                                  pytest.param(3, id="padded_three_rows")])
def test_batch_executor_runs_wrapper_as_unsharded(rows):
    """``BatchExecutor.run(hallthruster_jl, ...)`` builds the input tree and the
    config once from the whole batch and shards only the solve: every output
    equals the unsharded call's within 1e-6 scaled, with no NaN row when the
    batch does not divide the mesh."""
    x = {k: torch.tensor(v[:rows]) for k, v in WRAPPER_INPUTS.items()}
    got = BatchExecutor(Mesh(["cpu"] * 2)).run(hallthruster_jl, x, **WRAPPER_KW)
    ref = hallthruster_jl(x, **WRAPPER_KW)
    keys = [k for k, v in ref.items() if isinstance(v, torch.Tensor) and k != "model_cost"]
    assert {"T", "I_d", "I_B0", "u_ion", "eta_m"} <= set(keys)
    for key in keys:
        assert got[key].shape == ref[key].shape and got[key].shape[0] == rows, key
        assert np.isfinite(got[key].numpy()).all(), key
        assert _scaled(got[key], ref[key]) <= 1e-6, key


def test_wrapper_time_step_ignores_nan_rows():
    """A failed (NaN) row sets neither the grid nor the time step of its batch:
    the other rows come out as they do without it."""
    x = {k: torch.tensor(v) for k, v in WRAPPER_INPUTS.items()}
    with_nan = {k: torch.cat([v, torch.tensor([float("nan")])]) for k, v in x.items()}
    got = hallthruster_jl(with_nan, **WRAPPER_KW)
    ref = hallthruster_jl(x, **WRAPPER_KW)
    assert torch.isnan(got["T"][-1]) and np.isfinite(got["T"][:-1].numpy()).all()
    for key in ("T", "I_d", "I_B0", "u_ion"):
        assert _scaled(got[key][:-1], ref[key]) <= 1e-6, key


def test_mesh_and_shards():
    mesh = Mesh(["cpu", "cpu", "cpu"])
    assert mesh.shape == {"batch": 3} and mesh.n_devices == 3 and mesh.devices[0] == torch.device("cpu")
    shards = shard_batch({"x": np.arange(6.0), "y": {"z": torch.arange(12).reshape(6, 2)}}, mesh)
    assert isinstance(shards, Shards) and len(shards) == 3
    assert shards[1]["x"].tolist() == [2.0, 3.0] and shards[2]["y"]["z"].tolist() == [[8, 9], [10, 11]]
    assert shard_batch(shards, mesh) is shards
    out = sharded_call(lambda t, k: {"x": t["x"] * k, "n": len(t["x"])}, mesh)(shards, torch.tensor(2.0))
    assert out["x"].tolist() == [0.0, 2.0, 4.0, 6.0, 8.0, 10.0] and out["n"] == 2
    with pytest.raises(ValueError, match="divide"):
        shard_batch({"x": np.arange(7.0)}, mesh)


def test_make_mesh_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchExecutor()


def test_kernel_bookkeeping_under_threads():
    """The launch counts and the per-device constants under more threads than
    cores, with the interpreter switching threads every microsecond."""
    cfg = SolverConfig(num_cells=32, ncharge=1, dt=5e-9, duration=400 * 5e-9, average_start_time=1e-6)
    n_threads, n_each = 16, 500
    results = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _kernels.reset_counts()

        def work():
            for _ in range(n_each):
                _kernels._count("kstep")
            results.append(_kernels._constants(cfg, torch.device("cpu")))

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _kernels.launch_counts["kstep"] == n_threads * n_each
    finally:
        sys.setswitchinterval(old)
        _kernels.reset_counts()
    params = [p for p, _ in results]
    assert len({id(p) for p in params}) == n_threads  # each launch gets its own struct
    assert len({id(c) for _, c in results}) == 1
    assert all(bytes(p) == bytes(params[0]) for p in params)


# ------------------------------------------------------------------ torch.distributed
_WORKER = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["HTPEM_REPO"])
torch.set_num_threads(1)

from hallthrusterpem_tpu_torch.parallel import distributed as dist, sharded_call
from hallthrusterpem_tpu_torch.pem import CoupledPEM, default_coupled_inputs

rank = int(os.environ["HTPEM_RANK"])
dist.initialize(coordinator_address=os.environ["HTPEM_ADDRESS"], num_processes=2, process_id=rank,
                local_device_ids=["cpu", "cpu"])
assert dist.is_distributed()
mesh = dist.global_mesh()
assert mesh.n_devices == 2, mesh  # 2 processes x 2 shards

GLOBAL_N = 8
full = default_coupled_inputs(GLOBAL_N, device="cpu")
sl = dist.local_batch_slice(GLOBAL_N)
local = dist.process_local_batch({k: v[sl] for k, v in full.items()}, mesh)
pem = CoupledPEM(**eval(os.environ["HTPEM_SMALL"]), device="cpu")
out = sharded_call(pem, mesh)(local)
gathered = dist.gather_to_host({"T": out["T"], "I_d": out["I_d"], "j_ion": out["j_ion"]})
assert gathered["T"].shape == (GLOBAL_N,) and np.isfinite(gathered["T"]).all(), gathered["T"]
np.savez(os.environ["HTPEM_OUT"], **gathered)
torch.distributed.destroy_process_group()
print(f"RANK{rank}_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, HTPEM_REPO=str(REPO), HTPEM_RANK=str(rank), HTPEM_ADDRESS=f"127.0.0.1:{port}",
                   HTPEM_SMALL=repr(SMALL), HTPEM_OUT=str(tmp_path / f"rank{rank}.npz"))
        for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"RANK{rank}_OK" in out, out

    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    pem = CoupledPEM(**SMALL, device="cpu")
    alone = pem(default_coupled_inputs(8, device="cpu"))
    for key in ("T", "I_d", "j_ion"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])  # both ranks gather the same
        assert ranks[0][key].shape == tuple(alone[key].shape)
        assert _scaled(ranks[0][key], alone[key]) <= 1e-6, key


@pytest.fixture()
def no_cluster(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.setattr(dist, "_local_devices", None)


def test_single_process_fallback(no_cluster, monkeypatch):
    """Without a cluster in the environment, ``initialize`` joins nothing and the
    helpers work on this process's devices."""
    dist.initialize(local_device_ids=["cpu"])
    assert not dist.is_distributed() and not torch.distributed.is_initialized()
    mesh = dist.global_mesh()
    assert mesh.devices == (torch.device("cpu"),)
    assert dist.batch_sharding(mesh) == (mesh, "batch")
    local = dist.process_local_batch({"x": np.arange(8.0)}, mesh)
    out = sharded_call(lambda t: t["x"] * 3, mesh)(local)
    got = dist.gather_to_host(out)
    assert isinstance(got, np.ndarray) and np.allclose(got, np.arange(8.0) * 3)
    sl = dist.local_batch_slice(8)
    assert (sl.start, sl.stop) == (0, 8)

    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.setattr(dist, "_local_devices", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.initialize()  # nothing named: a no-op, and no CPU mesh behind the caller's back
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.global_mesh()


def test_unreachable_cluster_raises(no_cluster, monkeypatch):
    import datetime

    monkeypatch.setattr(dist, "INIT_TIMEOUT", datetime.timedelta(seconds=2))
    with pytest.raises(RuntimeError):
        dist.initialize(coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=2, process_id=1,
                        local_device_ids=["cpu"])
    assert not torch.distributed.is_initialized()
    with pytest.warns(UserWarning, match="no coordinator address"):
        dist.initialize(num_processes=2, process_id=0, local_device_ids=["cpu"])
    assert not dist.is_distributed()
