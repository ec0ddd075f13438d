"""Process start to the first timed call: imports, the CUDA context, the
system's load, the kernels' build or load, the warm-up call at the cell's own
shapes (and, in a traced run, the profiler's start)."""


def read(ctx):
    return ctx["setup_s"]
