"""Host milliseconds a realization under the program's span
``maria_torch.mapper.postprocess`` (BinMapper's ``postprocess``, the
map's copy to the host and ``make_map``), from the program's span
aggregates over the traced window; None where the program has no such
span."""


def read(ctx: dict):
    host_s = ctx["counters"].get("span.maria_torch.mapper.postprocess")
    return 1e3 * host_s / ctx["realizations"] if host_s and ctx["realizations"] else None
