"""retrain_coalitions_per_s: coalition values the program returned from
retrained models in the window, over the window's length
(`readers.coalitions_per_s`)."""

from benchmark.readers import coalitions_per_s as read  # noqa: F401
