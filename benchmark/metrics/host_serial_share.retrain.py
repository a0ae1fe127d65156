"""host_serial_share.retrain: the share of the window's retraining batch
seconds in which the host worked with nothing of the batch queued on the
card, in %: the sum over the batches of `lead_s` (the batch's start to the
end of its first epoch's draws: its initial parameters and streams drawn
and uploaded) and `record_s` (its bookkeeping after the harvest), over the
sum of their `seconds` (the program's `engine.batch` events). A program
whose batch events lack that split gives nothing."""


def read(ctx):
    batches = [b for b in ctx["batches"] if "record_s" in b and "seconds" in b]
    total = sum(b["seconds"] for b in batches)
    if not total:
        return None
    return 100.0 * sum(b.get("lead_s", 0.0) + b["record_s"] for b in batches) / total
