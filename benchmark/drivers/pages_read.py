"""Parquet row-group reads: one caller decoding row groups of Snappy pages
in a closed loop.

Each call is ``snappy_tpu_torch.ops.api.decompress_streams(bodies,
declens)`` on the next row group of the pool (``row_groups.pool``): every
page of the row group in one batched call, without checksums, as a GPU
Parquet reader makes it, then a raise on any nonzero error code. The
call returns the pages as a list; ``bytes()`` of it joins them, at check
time only. Each sampled call's pages are held to their chunks' bytes.

The port keeps ``api.routes`` for every call, warm-up and window
included, as a user's call does not: one tuple a launch group, about 7 us
of each group's ``pack`` part (three groups a call of about 0.9 s).
``pages_off_card`` counts the pages that no card route decoded: the rows
of each call's entries but ``"host"`` must add up to the pages handed to
it. The profiled calls' entries go to ``out.layer["routes"]`` for
``pad_pct.pages``.

The configuration guarantees that every page is validated on read and a
bad one reported by its code, the others of its row group decoding
exactly: after the calls, one row group with one page's copy offset set
past the bytes decoded before it and another page's declared length made
longer than its stream gives, both drawn from the seed, must come back
with a nonzero code at those two pages and every other page exact
(``errors_unreported``). The control is the port with its codes dropped,
a decoder that reports no error.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import faults, harness, routes, row_groups, single, traffic
from ..reference import pages as ref_pages


def run(ctx: harness.Context) -> harness.Outcome:
    with faults.planted(ctx.fault):
        return _run(ctx)


def _decoder(control: bool):
    """``(bodies, declens) -> (outputs, codes)``: the port, looked up at
    each call so that a planted fault takes its place; under ``control``
    with every code dropped."""
    from snappy_tpu_torch.ops import api

    def decode(bodies, declens):
        outs, errs, _ = api.decompress_streams(bodies, declens)
        return outs, (np.zeros_like(errs) if control else errs)
    return decode


def _unreported(corpus, item: row_groups.RowGroup, decode, seed: int) -> int:
    """Pages of one row group with a broken copy in one page and an overlong
    declared length in another, both drawn from the seed, that the decoder
    misreads: a bad page without a code, a good one with a code or other
    bytes; every page where the call raises."""
    rng = traffic._rng(seed, "pages-probe")
    bodies, declens = list(item.bodies), list(item.declens)
    bad_copy, bad_len = (int(j) for j in rng.choice(len(bodies), 2, replace=False))
    bodies[bad_copy] = ref_pages.break_copy(bodies[bad_copy], int(rng.integers(1 << 30)))
    declens[bad_len] += 1 + int(rng.integers(4096))
    try:
        outs, errs = decode(bodies, declens)
    except Exception as e:  # noqa: BLE001 - a raise reports no page
        print(f"the probe call failed: {type(e).__name__}: {e}", file=sys.stderr)
        return len(bodies)
    missed = int(errs[bad_copy] == 0) + int(errs[bad_len] == 0)
    for j, page in enumerate(item.pages):
        if j not in (bad_copy, bad_len):
            missed += int(errs[j] != 0 or outs[j] != row_groups.page_raw(corpus, page))
    return missed


def _run(ctx: harness.Context) -> harness.Outcome:
    from snappy_tpu_torch.ops import api

    harness.log("imports done")
    harness.configure_port(ctx.device, ctx.config.get("port"))
    corpus = traffic.load_corpus(ctx.config, ctx.cache_dir)
    ctx.reference_s = corpus.reference_s
    pool = row_groups.pool(corpus, row_groups.layout(corpus, ctx.config), ctx.traffic, ctx.seed)
    decode = _decoder(ctx.control)
    calls: list[tuple[int, list]] = []  # (pages handed, api.routes entries) a call

    def call(item: row_groups.RowGroup) -> row_groups.Pages:
        api.routes = []
        try:
            outs, errs = decode(item.bodies, item.declens)
        finally:
            calls.append((len(item.bodies), api.routes))
            api.routes = None
        bad = np.flatnonzero(errs)
        if bad.size:
            raise ValueError(f"page {bad[0]} of {len(errs)}: code {int(errs[bad[0]])}")
        return row_groups.Pages(outs)

    out = single.run(ctx, pool, call, expect=lambda item: row_groups.expected(corpus, item),
                     need=lambda item, got: item.in_bytes + item.raw_bytes)
    if ctx.trace:
        n = int(ctx.params["trace_calls"])
        out.layer["routes"] = calls[-2 * n : -n]  # the profiled stretch
    out.checks["pages_off_card"] = (routes.off_card(calls), 0)
    out.checks["errors_unreported"] = (_unreported(corpus, pool[0], decode, ctx.seed), 0)
    return out
