"""The program's spans (``repro_torch.spans``): off, they are one shared
null context and leave nothing in a profile; on, a profiler records them
under the program's prefix."""
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans


def _names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_off_a_span_is_the_shared_null_context_and_leaves_no_event():
    assert not torch.autograd._profiler_enabled()
    first, second = spans.span("gemm"), spans.span("attn")
    assert first is second
    with first:
        x = torch.ones(4) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = x * 2
    assert not [n for n in _names(prof) if n.startswith(spans.PREFIX)]
    assert y.sum().item() == 16.0


def test_on_a_span_is_recorded_under_the_prefix():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("gemm"):
            torch.ones(2, 2) @ torch.ones(2, 2)
    assert _names(prof).count("repro_torch.gemm") == 1
    assert spans.span("gemm") is spans.span("norm")     # off again
