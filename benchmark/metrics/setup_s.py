"""setup_s: seconds from the start of the run's harness to its first timed
request: imports, the CUDA context, the inputs made from the seed, the
program's scenario and staging, kernels loaded from the checkout's build
folder, the cell's recording where it has one, and the warm-up of the
shapes the window uses (host clock, on a synchronized card)."""


def read(ctx):
    return ctx["setup_s"]
