"""device.idle_pct: the share of the profiled slice (its first device
operation's start to its last one's end) in which no kernel, copy or
fill ran on the card."""


def read(trace):
    lo, hi = trace.window
    return 100.0 * (1.0 - trace.busy_s / (hi - lo)) if trace.ops and hi > lo else None
