"""device_idle_share.recon: the card's idle share of the traced
sub-window, in % (`readers.idle_share`)."""

from benchmark.readers import idle_share as read  # noqa: F401
