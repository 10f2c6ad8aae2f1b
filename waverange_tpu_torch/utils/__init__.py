from .diag import timed, get_timings, reset_timings, verbose  # noqa: F401
