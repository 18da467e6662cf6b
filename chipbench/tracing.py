"""The traced run's reading of the device: ``torch.profiler`` around the
window, read from its raw events (``kineto_results.events()``, not the
slow ``events()`` of Python objects).

The window is the benchmark's own span ``chipbench.window``. From the
events inside it: the device's busy time (the union of its kernels,
copies and sets), each kernel's device time by name, and the device's idle
gaps, each put to the host span that was innermost at the gap's middle
(the benchmark's spans ``chipbench.*`` and the program's aten ops).
"""
from __future__ import annotations

import bisect
import contextlib

import torch

from chipbench.stats import merge_intervals

WINDOW = "chipbench.window"
SMALL_GAP_NS = 5_000     # gaps shorter than this are summed under one name
TOP = 10


def span(name: str):
    """A host span the profiler records (a no-op cost when it is off)."""
    return torch.profiler.record_function(f"chipbench.{name}")


class Trace:
    """``with Trace(on, device):`` around the window; ``summary()`` after."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self._stack = contextlib.ExitStack()
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(torch.profiler.record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def summary(self) -> dict:
        """{"busy_s", "window_s", "kernels": {name: s}, "idle_by_host":
        {name: s}}; None when the run was not traced."""
        if self.prof is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu, window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                # the device's copy of a host span is no work of the device
                if not (e.is_user_annotation() or e.name().startswith("chipbench.")):
                    dev.append((start, start + dur, e.name()))
            elif e.name() == WINDOW:
                window = (start, start + dur)
            else:
                cpu.append((start, start + dur, e.name()))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        w0, w1 = window
        dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
        kernels: dict[str, float] = {}
        for s, e, n in dev:
            kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-9
        busy = merge_intervals((s, e) for s, e, _ in dev)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        return {"busy_s": sum(e - s for s, e in busy) * 1e-9,
                "window_s": (w1 - w0) * 1e-9,
                "kernels": kernels,
                "idle_by_host": _attribute(gaps, cpu)}


def _attribute(gaps, cpu) -> dict:
    """Each gap's seconds under the name of the innermost host event at
    its middle (the latest started that had not ended)."""
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 - g0 < SMALL_GAP_NS:
            name = f"gaps under {SMALL_GAP_NS // 1000} us"
        else:
            mid = (g0 + g1) / 2
            name = "host outside any op"
            k = bisect.bisect_right(starts, mid) - 1
            for j in range(k, max(k - 256, -1), -1):
                if cpu[j][1] >= mid:
                    name = cpu[j][2]
                    break
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle time by what the host was doing."""
    def top(d):
        return [[n[:120], s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(summary["kernels"]),
            "idle_gaps": top(summary["idle_by_host"])}
