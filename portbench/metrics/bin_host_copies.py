"""Device-to-host copies inside ``BinMapper.run()`` a realization, the
program's counter ``mapper.host_copies`` over the traced window; None
where the program has no such counter."""


def read(ctx: dict):
    copies = ctx["counters"].get("program.mapper.host_copies")
    return copies / ctx["realizations"] if copies and ctx["realizations"] else None
