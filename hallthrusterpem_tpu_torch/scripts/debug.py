"""Device and mesh smoke test (the JAX package's ``scripts/debug.py``): the
device inventory, one 512 x 512 product, and ``BatchExecutor`` over a mesh on a
batch that does not divide it (padding and trimming).

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.debug [-n 8]      # a mesh of the CUDA cards
  python -m hallthrusterpem_tpu_torch.scripts.debug --cpu       # Mesh(["cpu"] * 8)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("-n", "--devices", type=int, default=None, help="mesh size (default: all)")
parser.add_argument("--cpu", action="store_true", help="a mesh of 8 (or -n) CPU entries")


def main(argv=None):
    """Returns ``{"devices", "matmul_s", "mesh", "samples"}``."""
    args = parser.parse_args(argv)
    from hallthrusterpem_tpu_torch.parallel import BatchExecutor, Mesh, make_mesh

    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, devices: {cards or ['cpu']}")
    device = torch.device("cpu") if args.cpu else torch.device("cuda")

    t0 = time.perf_counter()
    x = torch.ones((512, 512), device=device) @ torch.ones((512, 512), device=device)
    val = float(x[0, 0])  # waits for the product
    matmul_s = time.perf_counter() - t0
    print(f"matmul round-trip: {matmul_s:.2f}s (val {val:.0f})")

    mesh = Mesh(["cpu"] * (args.devices or 8)) if args.cpu else make_mesh(args.devices)
    print(f"mesh: {[str(d) for d in mesh.devices]}")
    executor = BatchExecutor(mesh)

    def model(batch):
        return {"y": torch.sin(batch["x"]) * 2.0}

    n = 4 * executor.n_devices + 3  # deliberately non-multiple: exercises padding
    out = executor.run(model, {"x": np.linspace(0, 1, n)})
    y = out["y"].cpu().numpy()
    assert y.shape == (n,)
    assert np.allclose(y, 2 * np.sin(np.linspace(0, 1, n)), atol=1e-6)
    print(f"BatchExecutor over {executor.n_devices} devices: OK ({n} samples, padded + unpadded)")
    return {"devices": cards, "matmul_s": matmul_s, "mesh": [str(d) for d in mesh.devices], "samples": n}


if __name__ == "__main__":
    main()
