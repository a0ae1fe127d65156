"""The program's own counters, as the metric readers of `metrics/` read
them: the process-wide registry of `mplc_tpu_torch.obs.metrics`, which a
run's set-up fills in the same process."""


def program_counter(name: str):
    """The counter `name` of the program's registry, or None where the
    program never counted it (a program without that counter included)."""
    from mplc_tpu_torch.obs import metrics
    return metrics.snapshot()["counters"].get(name)
