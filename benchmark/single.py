"""The run of a cell with one caller in a closed loop, on one card.

A driver hands :func:`run` its pool of inputs, the call, what each input
must give (``expect``, from the reference) and the codec's bytes in and out
of a call (``need``, for the roofline). The run warms up on the pool's
first ``warm_calls`` inputs (every input of a cell has its size, and the
port builds nothing a stream), then measures the window under the
profiler, the card's activity only (:func:`trace.window_kernels`). The
traced run (``--trace 1``) then adds a profiled stretch of calls, host
activity too, and as many again with ``api.spans`` timing their parts.
Once the calls are done and the card's peak read, each sampled call's
result is held to what its input must give.
"""

from __future__ import annotations

import sys

from . import harness, trace
from .harness import Context, Outcome


def _guard(call, out: Outcome):
    def guarded(item):
        out.attempted += 1
        try:
            return call(item)
        except Exception as e:  # noqa: BLE001 - counted, and fails the run
            print(f"call failed: {type(e).__name__}: {e}", file=sys.stderr)
            out.failed += 1
            return None
    return guarded


def _quarters(pool, lat, done) -> list[float]:
    """The rate of each quarter of the window's calls, in GB/s, where every
    call returned: how far a run moves within itself, for the log."""
    if len(done) != len(lat) or len(lat) < 4:
        return []
    q = len(lat) // 4
    sizes = [pool[j].raw_bytes for j in done]
    return [sum(sizes[a:a + q]) / sum(lat[a:a + q]) / 1e9 for a in range(0, 4 * q, q)]


def run(ctx: Context, pool: list, call, expect, need) -> Outcome:
    """Returns the outcome, its checks ``mismatched_bytes``,
    ``failed_calls`` and ``unchecked`` set."""
    import torch

    from snappy_tpu_torch.ops import api

    p = ctx.params
    on_card = ctx.device != "cpu"
    out = Outcome()
    harness.log(f"pool of {len(pool)} inputs, {sum(i.in_bytes for i in pool)} bytes in")
    warm = pool[: int(p["warm_calls"])]
    t = harness.clock()
    for item in warm:
        call(item)
    est = (harness.clock() - t) / len(warm)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    harness.log(f"warm-up done, {est:.4f} s a call")
    keep = harness.sample(ctx.seed, int(ctx.seconds / max(est, 1e-6)) + 1,
                          int(p["check_calls"]))
    h0 = harness.host_state()
    # The program's set-up ends here: what follows until the first call is
    # the profiler's start (the benchmark's instrument, some seconds).
    p0 = harness.clock()
    (win, lat, done, kept, failed, cpu, t0), kernel_s = trace.window_kernels(
        lambda: harness.closed_loop(call, pool, ctx.seconds, keep), cuda=on_card)
    h1 = harness.host_state()
    harness.log(f"profiler start {t0 - p0:.4f} s; window: "
                + " ".join(f"{k} {h1[k] - h0[k]:.6g}" for k in h0)
                + f" kernel_s {kernel_s:.6g} quarters_GBps "
                + " ".join(f"{r:.4f}" for r in _quarters(pool, lat, done)))
    out.setup_s = p0 - harness.process_start() - ctx.reference_s
    out.window_s, out.latencies_s, out.cpu_s, out.kernel_s = win, lat, cpu, kernel_s
    out.attempted, out.failed = len(lat), failed
    out.bytes_done = sum(pool[j].raw_bytes for j in done)
    results = list(kept.values())
    if ctx.trace:
        n = int(p["trace_calls"])
        guarded = _guard(call, out)
        got, tr = trace.profile(lambda i: guarded(pool[i % len(pool)]), n, cuda=on_card)
        spans = []
        for i in range(n, 2 * n):
            api.spans = {}
            try:
                got.append(guarded(pool[i % len(pool)]))
            finally:
                spans.append(dict(api.spans))
                api.spans = None
        out.layer = {"spans": spans, "trace": tr,
                     "need_bytes": sum(need(pool[i % len(pool)], got[i]) for i in range(n)
                                       if got[i] is not None)}
        results += [(i % len(pool), r) for i, r in enumerate(got)]
    harness.log(f"{out.attempted} calls done")
    out.device = harness.card(ctx.device)
    bad = sum(harness.mismatched(r, expect(pool[j]))
              for j, r in results)
    out.checks = {"mismatched_bytes": (bad, 0), "failed_calls": (out.failed, 0),
                  "unchecked": (0 if results else 1, 0)}
    return out
