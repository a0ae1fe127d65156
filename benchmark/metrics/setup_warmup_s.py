"""setup_warmup_s: seconds of the warm-up inside set-up (one request of
each shape the window uses, on an engine or evaluator of its own, ending
on a synchronized card; harness clock)."""


def read(ctx):
    return ctx["warmup_s"]
