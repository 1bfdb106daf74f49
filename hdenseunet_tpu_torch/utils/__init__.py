from . import profiling, guards  # noqa: F401
