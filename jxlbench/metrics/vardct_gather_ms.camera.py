"""vardct_gather_ms.camera (program_span), layer device HF route /
reconstruction: the host gather of each LF group's reconstruction inputs
and their upload (ops/combine.py `lf_group_inputs` and `to_device`, the
mixed-group numpy gather): the wall time of the program's `vardct.gather`
spans (one an LF group, on the decode's pool threads where the group's
sections finished there), summed a frame, mean a request, in ms."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, "vardct.gather")
