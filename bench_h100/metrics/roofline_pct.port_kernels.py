"""roofline_pct.port_kernels: the summed least time of the stages the
program's own kernels ran in the profiled slice over those kernels'
summed device time.  A kernel's launches count the least time of its
stage kind (bench_h100/roofline.py KERNEL_KINDS) a tick, shared over that
kind's stages in a tick; a kernel of no known kind adds its device time
and no least time."""

from bench_h100.roofline import is_torch_op, kernel_kind


def read(trace):
    own = [o for o in trace.ops if not is_torch_op(o.name, o.cat)]
    if not own:
        return None
    stages = trace.stage_least()
    least = 0.0
    for o in own:
        kind = kernel_kind(o.name)
        if kind in stages:
            s, per_tick = stages[kind]
            least += s / per_tick
    return 100.0 * least / sum(o.dur for o in own)
