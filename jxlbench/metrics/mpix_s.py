"""mpix_s (end to end, host clock): the pixels of every request answered
inside the window over the window's seconds, in millions a second."""

from jxlbench import arith, readers


def read(ctx):
    px = ctx.cell.height * ctx.cell.width * len(readers.completed(ctx))
    return arith.rate(px / 1e6, ctx.seconds)
