from . import mind  # noqa: F401
