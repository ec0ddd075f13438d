"""Device-configuration loading from the port's packaged JSON device files
(the JSON twin of the JAX package's YAML ``load_thruster``), and the device
policy of the port's entry points."""

from __future__ import annotations

import json
from pathlib import Path

import torch

__all__ = ["load_thruster", "device_dir", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def device_dir() -> Path:
    """Directory containing the packaged device configurations."""
    return Path(__file__).parent / "devices"


def load_thruster(thruster_dir: str | Path, thruster_filename: str = "thruster.json") -> dict:
    """Load a device directory's JSON configuration. A bare packaged device name
    (``'SPT-100'``) is looked up in :func:`device_dir`. Top-level-or-nested string
    values that name a file of the directory are rewritten to absolute paths."""
    thruster_dir = Path(thruster_dir)
    if not thruster_dir.exists():
        candidate = device_dir() / thruster_dir.name
        if not candidate.exists():
            raise FileNotFoundError(f"Device directory {thruster_dir} not found")
        thruster_dir = candidate
    with open(thruster_dir / thruster_filename, encoding="utf-8") as fd:
        config = json.load(fd)

    files = {p.relative_to(thruster_dir).as_posix(): p.resolve().as_posix()
             for p in thruster_dir.rglob("*") if p.is_file() and p.name != thruster_filename}

    def rewrite(node):
        if isinstance(node, dict):
            return {k: rewrite(v) for k, v in node.items()}
        if isinstance(node, str) and node in files:
            return files[node]
        return node

    return rewrite(config)
