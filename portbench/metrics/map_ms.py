"""Mean milliseconds of the span around the mapping call (binning, or a
mapper's construction and fit), each ended by a synchronize, over the
traced window."""


def read(ctx: dict):
    spans = ctx["spans"].get("map")
    return 1e3 * sum(spans) / len(spans) if spans else None
