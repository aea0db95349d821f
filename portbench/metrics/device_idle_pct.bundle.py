"""device_idle_pct.bundle: share of the traced window (first batch's start
to last batch's end, on the profiler's clock) in which no kernel, copy or
set ran on the card, from the profiler's records."""

from portbench.trace import idle_pct


def read(run):
    if run.trace is None or run.kind != "bundle_verify":
        return None
    return idle_pct(run.trace)
