"""runtime.render_host_ms: host ms a tick inside ``Channel.render_frame``
(the benchmark's timer around the call), the mean over every tick of
the window outside the profiled slice."""


def read(trace):
    spans = trace.outside("Channel.render_frame")
    return 1e3 * sum(spans) / len(spans) if spans else None
