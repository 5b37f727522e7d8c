"""Natural coefficient order generation (reference j40.h:4980-5035).

order[i] gives the flat index into the canonical coefficient buffer for the
i-th decoded coefficient: first the LLF top-left (rows/8 x columns/8) block in
raster order, then zigzag diagonals skipping the LLF region.
"""

from __future__ import annotations

import functools

from ..mathutil import ceil_div


@functools.lru_cache(maxsize=None)
def natural_order(log_rows: int, log_columns: int) -> tuple[int, ...]:
    assert 8 >= log_columns >= log_rows >= 3
    size = 1 << (log_rows + log_columns)
    log_slope = log_columns - log_rows
    rows8 = 1 << (log_rows - 3)
    columns8 = 1 << (log_columns - 3)
    rows = 1 << log_rows
    columns = 1 << log_columns

    order = []
    for y in range(rows8):
        for x in range(columns8):
            order.append(y << log_columns | x)

    key1 = 1 << (log_columns - 3)
    while len(order) < size:
        x0 = key1 & ((1 << log_slope) - 1)
        y0 = key1 >> log_slope
        x1, y1 = key1, 0
        if x1 >= columns:
            excess = ceil_div(x1 - (columns - 1), 1 << log_slope)
            x1 -= excess << log_slope
            y1 += excess
        if y0 >= rows:
            excess = y0 - (rows - 1)
            x0 += excess << log_slope
            y0 -= excess
        if key1 & 1:
            x, y = x1, y1
            while x >= x0:
                if y >= rows8 or x >= columns8:
                    order.append(y << log_columns | x)
                x -= 1 << log_slope
                y += 1
        else:
            x, y = x0, y0
            while x <= x1:
                if y >= rows8 or x >= columns8:
                    order.append(y << log_columns | x)
                x += 1 << log_slope
                y -= 1
        key1 += 1
    assert len(order) == size
    return tuple(order)
