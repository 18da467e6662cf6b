"""Spans at the model's layer boundaries, recorded only while a torch
profiler records.

``with span("attn"):`` marks its block as ``repro_torch.attn`` in the
profiler's timeline, beside the device's kernels and the runtime calls
that launched them, so a trace can put each device operation and each idle
gap under the program layer that caused it. A span's parent is the span
enclosing it on the host thread.

With no profiler recording, ``span`` returns one shared null context: no
dispatcher op is added, so an op counter, a remat policy and every output
see the program as it is without spans.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """``repro_torch.<name>`` as a profiler span while a profiler records;
    else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
