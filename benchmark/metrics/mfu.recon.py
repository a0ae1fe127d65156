"""mfu.recon: the useful FLOPs of the window's reconstructed coalitions
over its seconds over the card's float32 peak, in % (`readers.mfu_recon`)."""

from benchmark.readers import mfu_recon as read  # noqa: F401
