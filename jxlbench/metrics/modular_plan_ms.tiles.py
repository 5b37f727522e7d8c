"""modular_plan_ms.tiles (program_span), layer device Modular route: the
lane plan of the Modular device route a request, which the route's
`setup_s` leaves out: the program's `modular.plan` spans
(ops/device_modular.py: each pass-group section read, its Modular header
parsed, its lane made), mean a request, in ms."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, "modular.plan")
