"""The share of the traced window in which no operation ran on the card
(1 minus the union of the trace's device intervals over the window), in
%."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
