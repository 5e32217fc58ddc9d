from . import generators  # noqa: F401
