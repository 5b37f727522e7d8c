"""copy_ms_per_image (device_trace), layer upload / fetch: the device time
of the slice's host-device copies (the profiler's Memcpy HtoD and DtoH
records) over the images whose work the slice holds, in ms."""

from jxlbench import readers

KERNELS = ("Memcpy HtoD", "Memcpy DtoH")


def read(ctx):
    reqs = readers.requests_in_slice(ctx)
    if not reqs:
        return None
    return 1e3 * ctx.slice.seconds(KERNELS) / reqs
