"""program.device_ops_per_tick: the card's kernels, copies and fills in
the profiled slice, over the ticks delivered in it."""


def read(trace):
    return len(trace.ops) / trace.slice_ticks if trace.ops and trace.slice_ticks else None
