"""mfu.retrain: the useful model FLOPs of the window's retrained coalitions
over its seconds over the card's float32 peak, in %
(`readers.mfu_retrain`)."""

from benchmark.readers import mfu_retrain as read  # noqa: F401
