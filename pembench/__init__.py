"""Benchmark of the PyTorch and CUDA port (hallthrusterpem_tpu_torch): the
harness (run.py), its traffic generator, work count, trace reader, check, the
per-layer and end-to-end metric readers, the plain reference and the frozen
configurations and data it reads. It imports nothing of JAX."""
