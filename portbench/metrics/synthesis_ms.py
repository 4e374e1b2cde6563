"""Mean milliseconds of the span around the synthesis call (the TOD of
one realization), each ended by a synchronize, over the traced window."""


def read(ctx: dict):
    spans = ctx["spans"].get("synthesis")
    return 1e3 * sum(spans) / len(spans) if spans else None
