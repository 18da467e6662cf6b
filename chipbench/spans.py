"""The program's layers in a traced window: the device time and the idle
time under each of the program's own spans (``repro_torch.*``, which the
program records only while a profiler records), and the host's time in
each.

Each device operation is linked to the runtime or driver call that
launched it (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``...) by the correlation id the profiler gives both, and
goes under the innermost program span that enclosed the call's start on
the launching thread: under ``OUTSIDE`` where no program span did (the
benchmark loop's own work), under ``UNLINKED`` where no launching call was
found. Each idle gap of the device goes under the innermost program span
at its middle. The window, the device's operations and its idle gaps are
those of ``chipbench.tracing.Trace.summary``.
"""
from __future__ import annotations

import torch

from chipbench.stats import merge_intervals
from chipbench.tracing import WINDOW

PROGRAM = "repro_torch."    # the program's spans
LAUNCH = "cu"               # the runtime's and the driver's calls
OUTSIDE, UNLINKED = "outside the program", "unlinked"


def events(prof) -> tuple:
    """From a finished ``torch.profiler`` profile: the window (start,
    end), the device's operations in it (start, end, name, correlation id;
    cut to the window), the launching calls (correlation id -> (start,
    thread)) and the program's spans (start, end, name, thread)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, launches, window = [], [], {}, None
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if e.device_type() == cuda:
            # the device's copy of a host span is no work of the device
            if not (e.is_user_annotation() or name.startswith(("chipbench.", PROGRAM))):
                dev.append((start, end, name, e.correlation_id()))
        elif name == WINDOW:
            window = (start, end)
        elif name.startswith(PROGRAM):
            spans.append((start, end, name, e.device_resource_id()))
        elif name.startswith(LAUNCH) and e.correlation_id():
            launches[e.correlation_id()] = (start, e.device_resource_id())
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in dev if e > w0 and s < w1]
    return window, dev, launches, spans


def read(prof) -> dict:
    """{"device_by_span", "idle_by_span", "host_by_span"}: seconds by span
    name in the window of a finished ``torch.profiler`` profile (a host
    span's own time, less its program children's)."""
    (w0, w1), dev, launches, spans = events(prof)
    busy = merge_intervals((s, e) for s, e, _, _ in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return {"device_by_span": device_by_span([(s, e, c) for s, e, _, c in dev],
                                             launches, spans),
            "idle_by_span": idle_by_span(gaps, spans),
            "host_by_span": host_by_span([s for s in spans if s[0] >= w0 and s[1] <= w1])}


def innermost(spans, points) -> list:
    """For each point (t, thread), the name of the innermost span (start,
    end, name, thread) on that thread that encloses t, or None: one sweep
    in time order with a stack of the open spans a thread (a thread's spans
    nest, so its innermost open span is the last opened)."""
    marks = []
    for i, (s, e, _, th) in enumerate(spans):
        marks.append((s, 0, -e, i, th))     # at one instant: spans open first
        marks.append((e, 2, -s, i, th))     # and close last, the inner first
    for j, (t, th) in enumerate(points):
        marks.append((t, 1, 0, j, th))
    marks.sort(key=lambda m: m[:4])
    stacks: dict = {}
    out = [None] * len(points)
    for _, kind, _, i, th in marks:
        stack = stacks.setdefault(th, [])
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            stack.remove(i)
        elif stack:
            out[i] = spans[stack[-1]][2]
    return out


def device_by_span(ops, launches, spans) -> dict:
    """Each device operation's seconds (ops: (start, end, correlation id))
    under the innermost span that enclosed the start of the call that
    launched it (launches: correlation id -> (start, thread)) on that
    call's thread; under ``OUTSIDE`` where none did, under ``UNLINKED``
    where no launching call was found. The parts sum to the operations'
    total."""
    linked = [(s, e, launches[c]) for s, e, c in ops if c in launches]
    names = innermost(spans, [call for _, _, call in linked])
    out: dict[str, float] = {}
    for (s, e, _), name in zip(linked, names):
        name = name or OUTSIDE
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    lost = sum(e - s for s, e, c in ops if c not in launches)
    if lost:
        out[UNLINKED] = lost * 1e-9
    return out


def idle_by_span(gaps, spans) -> dict:
    """Each idle gap's seconds (gaps: (start, end)) under the innermost
    span, on any thread, that encloses its middle, or under ``OUTSIDE``."""
    one = [(s, e, n, 0) for s, e, n, _ in spans]
    names = innermost(one, [((g0 + g1) / 2, 0) for g0, g1 in gaps])
    out: dict[str, float] = {}
    for (g0, g1), name in zip(gaps, names):
        name = name or OUTSIDE
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


def host_by_span(spans) -> dict:
    """Each span name's own host seconds: its spans' durations less the
    parts their child spans (on the same thread) cover."""
    out: dict[str, float] = {}
    stacks: dict = {}
    for s, e, name, th in sorted(spans, key=lambda x: (x[0], -x[1])):
        stack = stacks.setdefault(th, [])
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            parent = stack[-1][2]
            out[parent] = out.get(parent, 0.0) - (e - s) * 1e-9
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
        stack.append((s, e, name))
    return out
