"""Label one more training-data cache for the MLP surrogate (the JAX package's
``scripts/gen_mlp_data.py``).

One cache per seed (``<name>_mlp_train_data_s<seed>.pkl``, numpy only): a cache
resumes only at its own (n, seed). ``fit_surr --surrogate mlp`` concatenates
every cache of the run directory, either package's.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.gen_mlp_data -n 65536 --seed 8 --dir amisc_data \\
      [--trim amisc_data/domain_classifier.pkl] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    """Returns the path of the cache."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-n", "--num_samples", type=int, default=65536)
    parser.add_argument("--seed", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=1024)
    parser.add_argument("--dir", default="amisc_data", help="run directory holding <name>_compression.json")
    parser.add_argument("--config", default="pem_v0_SPT-100_compression.json",
                        help="file name of the compression save in --dir")
    parser.add_argument("--trim", default=None, help="domain classifier pickle (trim_domain)")
    parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")
    args = parser.parse_args(argv)

    from hallthrusterpem_tpu_torch.core.system import System
    from hallthrusterpem_tpu_torch.surrogate.domain import FailureClassifier, make_domain_filter
    from hallthrusterpem_tpu_torch.surrogate.mlp import generate_training_data

    run_dir = Path(args.dir)
    system = System.load_from_file(run_dir / args.config, device=args.device)
    system.set_logger(stdout=True)
    domain_filter = None
    if args.trim:
        domain_filter = make_domain_filter(FailureClassifier.load(args.trim), system)
    cache = run_dir / f"{system.name}_mlp_train_data_s{args.seed}.pkl"
    generate_training_data(system, args.num_samples, seed=args.seed, chunk=args.chunk,
                           cache_path=cache, domain_filter=domain_filter)
    print(f"done -> {cache}")
    return cache


if __name__ == "__main__":
    main()
