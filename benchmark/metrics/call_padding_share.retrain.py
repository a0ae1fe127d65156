"""call_padding_share.retrain: the padded copies among the models of the
window's gradient calls, in % (the program's `engine.batch` events:
`models_padded` over `models_called`). Every gradient call holds the
model's `grad_call_width` models, the last of a step padded with copies
of its first, whose results are dropped; coalition rows padded to a
batch's width (`padding_share.retrain`) are models of their calls here."""


def read(ctx):
    batches = [b for b in ctx["batches"] if "models_called" in b]
    called = sum(b["models_called"] for b in batches)
    if not called:
        return None
    return 100.0 * sum(b["models_padded"] for b in batches) / called
