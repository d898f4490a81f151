"""The port's span recorder. Every stage opens its own parts with
:func:`span`; a public entry is a call (:func:`entry`, :func:`call`), whose
root part the stages' parts nest under. :data:`spans` and :data:`records`
are its two views, and it waits for the card only when a call ends. It
imports nothing of the package, so that every stage can import it.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import resource
import threading
import time

import torch

#: Seconds spent in each part of the decodes and compresses run while this
#: is a dict (set it to ``{}`` to start, ``None`` to stop), added when each
#: call ends. Host parts are timed with ``time.perf_counter_ns``: ``walk``
#: (frame chunk walk), ``pack`` (splitting, grouping and padding rows, the
#: call's own buffers, and the configuration and device that a decode call
#: and each of its launch groups read to choose their route: every field's
#: environment variable, each time), ``flatten`` (native index
#: flatten, and its fallback check), ``scan`` (native op-record scan),
#: ``h2d`` and ``d2h`` (copies; the flatten's indices are let go in the
#: ``h2d`` that copies them), ``host_decode`` (oversized rows; its bytes
#: their outputs), ``unpack`` (rows to bytes), ``stored_crc`` (checksums of
#: uncompressed chunks and the check of every chunk's) and ``join`` (and
#: letting go of the chunks' buffers).
#: Device parts are timed between two CUDA events and wait for nothing:
#: ``kernels`` (the launches), for the fast compress ``prepass`` and
#: ``plan`` (the tensor ops before K4 and before K5), for the resolve route
#: ``plan`` (its tensor ops around K8 or K9), for the tensor decode routes
#: ``tensor`` (their tensor ops and CRC launch), and for the device frame
#: writer ``assemble`` (the chunk framing). A host part leaves out the
#: time that the call's device parts before it ran while it was open (its
#: record's ``wait_s``: the ``d2h`` after K2 and K1 waits for them), so the
#: parts add up to no more than the call. ``scan`` also times the host's
#: op-start bitmaps of the hosted tensor route.
spans: dict[str, float] | None = None

#: One record a part of every call run while this is a list (set it to
#: ``[]`` to start, ``None`` to stop), a call's records appended when the
#: call ends. Each is a dict: ``call`` (the id of the public call it
#: belongs to: its root record's ``id``), ``id``, ``parent`` (``None`` on a
#: root), ``name`` (a part named as in :data:`spans`, or on a root the
#: public entry: ``decompress_frame``, ``decompress_streams``,
#: ``decompress``, ``compress``, ``read.FrameDecoder``,
#: ``write.FrameEncoder``), ``thread`` (its native id), ``t0_ns`` and
#: ``t1_ns`` (``time.perf_counter_ns``), ``cpu_user_s``, ``cpu_sys_s`` and
#: ``minflt`` (the process's ``getrusage`` across the part: every thread,
#: the flatten's included), ``bytes`` (those the part moves or makes: the
#: stream walked, the ``nbytes`` copied in or back, the flatten's indices
#: and tile meta, the bytes unpacked, checksummed or joined; else 0) and
#: ``device_s`` (a device part's seconds between its two CUDA events, else
#: ``None``) and ``wait_s`` (how long the call's earlier device parts ran
#: while a host part was open, as their events place them: the wait of a
#: copy back for the kernels before it; 0 on a device part). A root also
#: keeps ``anchor``, ``(time.time_ns(), time.perf_counter_ns())`` read as
#: it opened, which places its call's clock times on a ``torch.profiler``
#: trace's: a time ``t`` is at ``(anchor[0] + t - anchor[1] -
#: baseTimeNanoseconds) / 1000`` µs of the trace's ``ts``.
records: list[dict] | None = None

#: ``(call, id)`` of the innermost open part in this context; a sharded
#: entry's shard threads run in a copy of their caller's context, so their
#: parts take the caller's as parent.
_current: contextvars.ContextVar[tuple[int, int] | None] = contextvars.ContextVar(
    "snappy_tpu_torch_span", default=None)
_ids = itertools.count(1)
#: Each open call's closed records and its device parts' events, by call.
_open: dict[int, tuple[list[dict], list]] = {}
#: Calls end on many threads at once; each adds to :data:`spans` under it.
_sum_lock = threading.Lock()


def _label(name: str):
    """Open a range named ``name`` of a running ``torch.profiler`` trace
    (the range ``record_function`` makes, opened without its operator
    dispatch, so that little of its cost falls between two ranges); returns
    its handle for :func:`_unlabel`, ``None`` with no profiler running."""
    if torch.autograd._profiler_enabled():
        return torch.autograd._record_function_with_args_enter(name)
    return None


def _unlabel(handle) -> None:
    if handle is not None:
        torch.autograd._record_function_with_args_exit(handle)


@contextlib.contextmanager
def span(name: str, dev: torch.device | None = None, nbytes: int = 0, root: bool = False):
    """One part of a call, ``name``, for :data:`spans` and :data:`records`
    while either is on; with a CUDA ``dev``, the device time of what it
    launches. ``nbytes`` is what the part moves or makes. A part opened in
    no call opens one; ``root=True`` marks a public entry, which inside an
    open call joins that call and records nothing. Under a running
    ``torch.profiler`` (``utils.profiling.device_trace``) the body is also a
    labelled range of the trace, so its host gaps carry names. With both
    views off it costs no clock, ``getrusage`` or event."""
    if spans is None and records is None:
        if not torch.autograd._profiler_enabled():
            yield
            return
        handle = _label(name)
        try:
            yield
        finally:
            _unlabel(handle)
        return
    cur = _current.get()
    if root and cur is not None:
        yield
        return
    sid = next(_ids)
    # The part's own bookkeeping lies between t0 and t1, and inside its
    # profiler range, so that the gaps between parts hold only the caller's
    # work and a record starts where its range does.
    t0 = time.perf_counter_ns()
    if cur is None:
        anchor = (time.time_ns(), time.perf_counter_ns())
    handle = _label(name)
    call_id = sid if cur is None else cur[0]
    if cur is None:
        _open[call_id] = ([], [])
    token = _current.set((call_id, sid))
    events = None
    if dev is not None and dev.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    keep = records is not None  # host CPU and faults only for the records
    ru0 = resource.getrusage(resource.RUSAGE_SELF) if keep else None
    try:
        if events is not None:
            queued = time.perf_counter_ns()
            events[0].record()
        try:
            yield
        finally:
            if events is not None:
                events[1].record()
    finally:
        ru1 = resource.getrusage(resource.RUSAGE_SELF) if keep else None
        _current.reset(token)
        rec = {"call": call_id, "id": sid, "parent": None if cur is None else cur[1],
               "name": name, "thread": threading.get_native_id(), "t0_ns": t0, "t1_ns": t0,
               "cpu_user_s": ru1.ru_utime - ru0.ru_utime if keep else None,
               "cpu_sys_s": ru1.ru_stime - ru0.ru_stime if keep else None,
               "minflt": ru1.ru_minflt - ru0.ru_minflt if keep else None,
               "bytes": nbytes, "device_s": None, "wait_s": 0.0}
        done, pending = _open[call_id]
        done.append(rec)
        if events is not None:
            pending.append((rec, queued, *events))
        _unlabel(handle)
        rec["t1_ns"] = time.perf_counter_ns()
        if cur is None:
            rec["anchor"] = anchor
            _end_call(call_id, entry=root)


def _resolve(pending) -> list[tuple[int, int, int, int]]:
    """Each device part's seconds between its two events. A call's own copy
    back has waited for its launches, so the events are done by now.
    Returns where each ran on the host's clock, ``(thread, closed, start,
    end)`` in ns: from when its first event was queued, or when the
    thread's device part before it ended if later, for its seconds."""
    ran, last = [], {}
    for rec, queued, start, stop in pending:
        stop.synchronize()
        rec["device_s"] = start.elapsed_time(stop) / 1e3
        th = rec["thread"]
        a = max(queued, last.get(th, queued))
        last[th] = b = a + round(rec["device_s"] * 1e9)
        ran.append((th, rec["t1_ns"], a, b))
    return ran


def _set_waits(done: list[dict], ran: list[tuple[int, int, int, int]]) -> None:
    """Each host part's ``wait_s``: how long the device parts that its
    thread closed before it opened ran while it was open. :data:`spans`
    leaves that time out of the host part, which keeps the parts disjoint:
    what the card ran belongs to the device part that launched it, also
    where a host part (the copy back) waited for it."""
    if not ran:
        return
    for rec in done:
        if rec["device_s"] is None:
            t0, t1, th = rec["t0_ns"], rec["t1_ns"], rec["thread"]
            rec["wait_s"] = sum(max(0, min(t1, b) - max(t0, a))
                                for th_d, closed, a, b in ran
                                if th_d == th and closed <= t0) / 1e9


def _end_call(call_id: int, entry: bool) -> None:
    """Hand the records of the call that just ended to the views that are on:
    all of them to :data:`records`, and but an entry's root, by name, to
    :data:`spans`: a device part's seconds on the card, a host part's on the
    host's clock less its ``wait_s``."""
    done, pending = _open.pop(call_id)
    _set_waits(done, _resolve(pending))
    by_name, out = spans, records
    if by_name is not None:
        with _sum_lock:
            for rec in done[:-1] if entry else done:
                dt = rec["device_s"]
                if dt is None:
                    dt = (rec["t1_ns"] - rec["t0_ns"]) / 1e9 - rec["wait_s"]
                by_name[rec["name"]] = by_name.get(rec["name"], 0.0) + dt
    if out is not None:
        out.extend(done)


def call(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as a call whose root part is ``name``; straight
    through while neither view nor a profiler is on."""
    if spans is None and records is None and not torch.autograd._profiler_enabled():
        return fn(*args, **kwargs)
    with span(name, root=True):
        return fn(*args, **kwargs)


def entry(fn):
    """Run the public entry ``fn`` as a call: a root part named after it."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        return call(fn.__name__, fn, *args, **kwargs)
    return run
