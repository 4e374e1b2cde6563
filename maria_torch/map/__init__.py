from .projection import ProjectionMap  # noqa: F401
