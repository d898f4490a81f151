"""What the port's ``api.routes`` entries of a run say: one entry a decode
launch group, ``(rows, d_pad, route, width, live_in, live_out)``.

A driver that keeps the entries keeps each call's as ``(pages handed,
entries)``. The check :func:`off_card` reads only ``rows`` and ``route``,
which every version of the port lists; a version that lists no entry for a
group turned down to the host codec leaves its rows missing, which counts
them off the card all the same. :func:`pad_pct` reads the traced calls'
entries (``out.layer["routes"]``) and returns ``None`` where an entry lacks
the last three fields.
"""

from __future__ import annotations

#: The route of a group that the host codec decoded.
HOST = "host"


def off_card(calls: list[tuple[int, list[tuple]]]) -> int:
    """Pages handed to the calls that no card route decoded."""
    return sum(max(0, n - sum(r[0] for r in rs if r[2] != HOST)) for n, rs in calls)


def pad_pct(o) -> float | None:
    """Padding over all the bytes the traced calls' groups placed on the
    card, sources and outputs, %."""
    entries = [r for _, rs in o.layer.get("routes") or [] for r in rs]
    if any(len(r) < 6 for r in entries):
        return None
    card = [r for r in entries if r[2] != HOST]
    placed = sum(r[0] * (r[3] + r[1]) for r in card)
    if not placed:
        return None
    return 100.0 * (placed - sum(r[4] + r[5] for r in card)) / placed
