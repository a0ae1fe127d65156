"""setup_record_s: the seconds of the grand coalition's recording run made
in set-up (the program's `recon.record_seconds_total`, fed by its
`recon.record` span)."""

from benchmark.counters import program_counter


def read(ctx):
    return program_counter("recon.record_seconds_total")
