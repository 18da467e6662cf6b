"""One module a kind of traffic (``chipbench/loops/<loop>.py``, named
by the workload file's ``loop``), each with ``setup(run)``, ``window(run,
state, seconds, trace)`` and ``served(run, state, records, rng, n)``: what
set-up warms and prepares, the timed window, and a sample of the window's
served outputs for the comparison with the reference."""
