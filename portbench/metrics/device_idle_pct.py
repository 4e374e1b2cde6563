"""The share of the traced window in which no kernel, copy or fill ran
on the card (the union of their intervals, overlaps counted once)."""


def read(ctx: dict):
    t = ctx["trace"]
    if not ctx["cuda"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
