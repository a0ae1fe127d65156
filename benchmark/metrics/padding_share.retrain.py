"""padding_share.retrain: the padded coalition rows of the window's
batches over their rows, in % (the program's `engine.batch` events:
`padding` over `width`). A padded row trains a copy of its batch's first
coalition and is dropped."""


def read(ctx):
    batches = ctx["batches"]
    rows = sum(b["width"] for b in batches)
    if not rows:
        return None
    return 100.0 * sum(b["padding"] for b in batches) / rows
