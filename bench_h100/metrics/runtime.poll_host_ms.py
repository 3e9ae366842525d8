"""runtime.poll_host_ms: host ms a tick in the channel's ``Layer.poll``
calls (each layer's ``poll`` wrapped), summed over a tick's layers and
averaged over the ticks of the window outside the profiled slice."""


def read(trace):
    ticks = trace.outside("Channel.render_frame")
    polls = trace.outside("Layer.poll")
    return 1e3 * sum(polls) / len(ticks) if ticks and polls else None
