"""What the metric readers of `metrics/` share: a reader whose metric is
split by suffix (`device_idle_share.retrain`, `.recon`) re-exports one of
these as its `read(ctx)`. Each returns None where it finds nothing to
read."""

from . import flops


def coalitions_per_s(ctx):
    """Coalition values the program returned in the window, over the
    window's length (host clock; the window closes at a batch's harvest,
    which reads the card)."""
    return ctx["coalitions"] / ctx["window_s"]


def idle_share(ctx):
    """The share of the traced sub-window (whole requests, synchronized at
    both ends) in which no operation ran on the card, in %: 1 - the union
    of the trace's device intervals over the sub-window."""
    s = ctx["trace"]
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def _share_of_peak(ctx, work: float):
    return 100.0 * work / ctx["window_s"] / ctx["peaks"]["fp32_flops"]


def mfu_retrain(ctx):
    """The useful model FLOPs of the coalitions retrained in the window
    (`flops.retrain_flops`: 3x the forward FLOPs a training row of a
    member, 1x a test row), over the window's seconds, over the card's
    float32 peak, in % (the configurations compute in float32 with TF32
    off, so no tensor core does model arithmetic)."""
    if ctx["peaks"] is None:
        return None
    return _share_of_peak(ctx, sum(
        flops.retrain_flops(ctx["cfg"], ctx["forward_flops"], ctx["partner_sizes"], c,
                            ctx["epochs"], ctx["test_rows"]) for _, c, _ in ctx["answers"]))


def mfu_recon(ctx):
    """The useful FLOPs of the coalitions reconstructed in the window (each
    one's row of the reconstruction kernel, 2 K Dp, and its test
    evaluation, 1x the forward FLOPs a test row), likewise."""
    if ctx["peaks"] is None or ctx["recon"] is None:
        return None
    return _share_of_peak(ctx, flops.recon_flops(
        ctx["forward_flops"], ctx["test_rows"], len(ctx["answers"]), ctx["recon"]["K"],
        ctx["recon"]["Dp"]))
