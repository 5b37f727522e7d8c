"""setup_s (end to end, host clock): from the process's start to the first
timed request, less the making of the inputs (corpus_s, printed on an
earlier line): the torch import, the CUDA context, the kernel library and
the native core (built on a checkout's first run), and the warm-up decodes
of every request shape of the cell."""


def read(ctx):
    return ctx.setup_s
