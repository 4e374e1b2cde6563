"""Kernel launches in the traced window over the realizations traced."""


def read(ctx: dict):
    if not ctx["cuda"] or not ctx["realizations"]:
        return None
    return len(ctx["trace"]["kernels"]) / ctx["realizations"]
