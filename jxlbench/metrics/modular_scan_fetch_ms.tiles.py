"""modular_scan_fetch_ms.tiles (program_span), layer device Modular route: the program's clock of B6, the wavefronts and the one fetch (stats device_modular scan_fetch_s), mean a request."""

from jxlbench import readers


def read(ctx):
    return readers.stat_mean_ms(ctx, "device_modular", "scan_fetch_s")
