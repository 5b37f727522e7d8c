"""Facts of a stream that the metrics count work from, read with the frozen
copy's own header parser (never the program's)."""

from __future__ import annotations

from jxlbench.frozen.headers.frame import read_frame_header, read_toc
from jxlbench.frozen.headers.image import read_image_metadata, read_signature
from jxlbench.frozen.io.bits import BitReader
from jxlbench.frozen.limits import MAIN_LV5


def facts(data: bytes) -> dict:
    """Bytes of the pass-group sections (what the entropy kernels read), of
    all sections, and the image's size."""
    r = BitReader(data)
    read_signature(r)
    im = read_image_metadata(r, MAIN_LV5)
    f = read_frame_header(r, im, MAIN_LV5)
    toc = read_toc(r, f)
    if toc.sections:
        group = sum(s.size for s in toc.sections if s.pass_ >= 0)
        total = toc.end_codeoff - min(s.codeoff for s in toc.sections if s.codeoff >= 0)
    else:
        group = total = toc.single_size
    return {"group_bytes": group, "section_bytes": total, "stream_bytes": len(data),
            "width": im.width, "height": im.height, "groups": max(1, f.num_groups)}
