"""Cross-cutting utilities (profiling, the C++ oracle).

Kept outside the codec path: the library itself stays pure (values and
exceptions only); stats belong to the CLI and the measurement scripts.
"""

from .profiling import device_trace, timed  # noqa: F401
