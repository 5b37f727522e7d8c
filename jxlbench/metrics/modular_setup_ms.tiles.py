"""modular_setup_ms.tiles (program_span), layer device Modular route: the program's clock of its host lane plan and packing (stats device_modular setup_s), mean a request."""

from jxlbench import readers


def read(ctx):
    return readers.stat_mean_ms(ctx, "device_modular", "setup_s")
