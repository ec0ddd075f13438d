"""Build of the port's hand-written CUDA kernels, shared by their bindings: the
discharge solver's (``models/thruster/_kernels.py``) and the plume's
(``models/plume.py``). :data:`SOURCES` lists every library.

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``build/torch_kernels/`` at the root of
the checkout, keyed by a hash of the source, its headers and the flags. The
first :func:`library` call builds every library not yet loaded, one nvcc
process each, all started together, so a binding used later finds its library
built. A failed build breaks only its own library: :func:`library` raises
nvcc's log for that name alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SOURCES", "build_all", "build_dir", "build_info", "library"]

#: precise math and no FMA contraction: a kernel rounds as its plain version does
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
_MODELS = Path(__file__).parent / "models"
_SOLVER = _MODELS / "thruster" / "csrc"
#: library name -> (source, the headers it includes)
SOURCES = {
    "kstep": (_SOLVER / "kstep.cu", (_SOLVER / "physics.cuh",)),
    "step": (_SOLVER / "step.cu", (_SOLVER / "physics.cuh",)),
    "plume": (_MODELS / "csrc" / "plume.cu", ()),
}
#: per library, what its build did: seconds, whether it was cached, nvcc's -Xptxas -v lines
build_info: dict = {}

#: library name -> the loaded library, or the RuntimeError its build raised
_libs: dict = {}
_lock = threading.Lock()


def build_dir() -> Path:
    """``build/torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[1] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def _build(names) -> dict:
    """Each of ``names`` -> the path of its library, or nvcc's error; the
    missing libraries are built with one nvcc process each, started together."""
    out_dir = build_dir()
    out, procs, nvcc = {}, {}, None
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        for name in names:
            src, headers = SOURCES[name]
            text = src.read_bytes() + b"".join(h.read_bytes() for h in headers)
            key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            lib_path = out[name] = out_dir / f"{name}_{key}.so"
            log_path = lib_path.with_suffix(".log")
            if lib_path.exists():
                build_info[name] = dict(seconds=0.0, cached=True, path=str(lib_path),
                                        log=log_path.read_text() if log_path.exists() else "")
                continue
            tmp_lib = Path(tmp) / lib_path.name
            nvcc = nvcc or _nvcc()
            procs[name] = (time.perf_counter(), tmp_lib, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp_lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (t0, tmp_lib, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                out[name] = f"nvcc failed to build {SOURCES[name][0].name}:\n{log}"
                continue
            out[name].with_suffix(".log").write_text(log)
            os.replace(tmp_lib, out[name])  # atomic: a concurrent build never sees a partial file
            build_info[name] = dict(seconds=time.perf_counter() - t0, cached=False,
                                    path=str(out[name]), log=log)
    return out


def build_all() -> dict:
    """Path of every library, building the missing ones together; raises if
    any build failed."""
    out = _build(list(SOURCES))
    failed = [v for v in out.values() if isinstance(v, str)]
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built (once per source hash) together with
    every other library not yet loaded."""
    with _lock:
        if name not in _libs:
            for n, built in _build([n for n in SOURCES if n not in _libs]).items():
                _libs[n] = RuntimeError(built) if isinstance(built, str) else ctypes.CDLL(str(built))
        lib = _libs[name]
    if isinstance(lib, Exception):
        raise lib
    return lib
