"""Seconds from before the scene's ``Simulation`` to the synchronize after
the program and what the entry builds once (pixel ids, a mapper's
geometry): the host span of the scene's set-up."""


def read(ctx: dict):
    return ctx["scene_setup_s"]
