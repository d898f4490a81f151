"""Padding of the traced row groups on the card, %: each card group's
``rows * width - live_in`` source bytes and ``rows * d_pad - live_out``
output bytes past its streams, over ``rows * (width + d_pad)`` (the
``api.routes`` entries; ``None`` where the port lists no group's bytes)."""

from benchmark.routes import pad_pct as read  # noqa: F401
