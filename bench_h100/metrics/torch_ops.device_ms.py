"""torch_ops.device_ms: device ms a tick in operations PyTorch launched
(its kernels, copies and fills), not the program's own kernels, in the
profiled slice."""

from bench_h100.roofline import is_torch_op


def read(trace):
    if not trace.ops or not trace.slice_ticks:
        return None
    return 1e3 * sum(o.dur for o in trace.ops if is_torch_op(o.name, o.cat)) / trace.slice_ticks
