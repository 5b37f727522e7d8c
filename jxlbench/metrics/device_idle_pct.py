"""device_idle_pct (device_trace), layer device: 100 x (1 - the union of
every CUDA activity interval, kernels, copies and sets, over the wall time
of the profiled slice)."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.t1 <= sl.t0:
        return None
    return 100.0 * (1.0 - sl.busy() / (sl.t1 - sl.t0))
