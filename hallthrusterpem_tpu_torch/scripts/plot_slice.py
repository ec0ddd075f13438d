"""1-D slices of a trained surrogate against the true model (the JAX package's
``scripts/plot_slice.py``): each chosen input swept over its domain, the others
at nominal (or along random lines with ``-r``), each chosen output drawn for
both. matplotlib is needed and imported only when the figure is drawn.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.plot_slice amisc_data --search [-i P_b V_a] [-o T I_d] [-n 15] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from hallthrusterpem_tpu_torch.core.json_loader import find_latest_save
from hallthrusterpem_tpu_torch.core.system import System

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file")
parser.add_argument("--search", action="store_true", help="find the newest trained/iteration/compression save")
parser.add_argument("-i", "--inputs", nargs="*", default=None)
parser.add_argument("-o", "--outputs", nargs="*", default=None)
parser.add_argument("-n", "--num_steps", type=int, default=15)
parser.add_argument("-r", "--random_walk", action="store_true")
parser.add_argument("-e", "--executor", default="batch", help="(parity flag)")
parser.add_argument("--save", default="slice.png")
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def main(argv=None):
    args = parser.parse_args(argv)
    path = Path(args.config_file)
    if args.search:
        path = find_latest_save(path)
    system = System.load_from_file(path, device=args.device)
    system.set_logger(stdout=True)
    system.plot_slice(
        inputs=args.inputs,
        outputs=args.outputs,
        num_steps=args.num_steps,
        random_walk=args.random_walk,
        save_path=args.save,
    )
    system.logger.info("saved %s", args.save)


if __name__ == "__main__":
    main()
