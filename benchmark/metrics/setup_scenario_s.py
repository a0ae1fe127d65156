"""setup_scenario_s: the seconds the program spent preparing its scenario
in this run: the `Dataset` built (and its held-out test split) and each
step of the `Scenario`'s preparation (the program's
`scenario.prepare_seconds_total`, fed by its `data.prepare` and
`scenario.prepare` spans)."""

from benchmark.counters import program_counter


def read(ctx):
    return program_counter("scenario.prepare_seconds_total")
