"""setup_stage_s: the seconds the program spent staging the scenario's
data on the card (`engine.stage_seconds_total`) and loading its CUDA
kernels' libraries, building any the checkout's build folder lacks
(`kernels.load_seconds_total`, absent where no kernel was loaded)."""

from benchmark.counters import program_counter


def read(ctx):
    stage = program_counter("engine.stage_seconds_total")
    if stage is None:
        return None
    return stage + (program_counter("kernels.load_seconds_total") or 0.0)
