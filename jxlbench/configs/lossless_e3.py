"""lossless_e3's stream and its plain reference.

The stream is the frozen encoder's lossless Modular frame in the shape that
libjxl gives cjxl -d 0 -e 3 (lib/jxl/enc_modular.cc): the YCoCg RCT (type
6) over the three colour channels, and the fixed tree of PredefinedTree's
kWPFixedDC, which MakeFixedTree builds as a balanced search over 33 cutoffs
of the weighted predictor's max-error property (15), every leaf the
weighted predictor (6).  The format's guarantee is that the decode gives
back every sample: the reference is the seed's image itself, 8-bit RGB with
an opaque alpha.

The configuration states no float precision, so the control breaks the
guarantee it states: the image at 7 bits a sample (the lowest bit cleared),
the answer of a decode that loses one bit.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from jxlbench.frozen.encode.advanced import AdvancedOptions, encode_modular_advanced
from jxlbench.frozen.encode.modular_enc import branch, leaf

#: kWPFixedDC's cutoffs of the WP max-error property
WP_CUTOFFS = (-500, -392, -255, -191, -127, -95, -63, -47, -31, -23, -15, -11, -7, -4, -3, -1,
              0, 1, 3, 5, 7, 11, 15, 23, 31, 47, 63, 95, 127, 191, 255, 392, 500)
WP_PROPERTY, WP_PREDICTOR = 15, 6


def fixed_tree(prop: int, cutoffs, predictor: int) -> list:
    """MakeFixedTree for an 8-bit image of at least 2**14 samples (no
    cutoff scaling, no height limit): the median cutoff splits, the upper
    half goes left (property > cutoff), each half split again, breadth
    first, which is the order the wire holds the nodes in."""
    tree = [leaf(predictor)]
    todo = deque([(0, len(cutoffs), 0)])
    while todo:
        begin, end, pos = todo.popleft()
        if begin >= end:
            continue
        mid = (begin + end) // 2
        n = len(tree)
        tree[pos] = branch(prop, cutoffs[mid], n, n + 1)
        todo.append((mid + 1, end, n))
        tree.append(leaf(predictor))
        todo.append((begin, mid, n + 1))
        tree.append(leaf(predictor))
    return tree


def leaf_depths(tree, i: int = 0) -> list[int]:
    node = tree[i]
    if node.is_leaf:
        return [0]
    return [1 + d for c in (node.left, node.right) for d in leaf_depths(tree, c)]


E3_TREE = fixed_tree(WP_PROPERTY, WP_CUTOFFS, WP_PREDICTOR)
#: branch levels the shortest walk of E3_TREE takes (the W3 roofline's
#: least count a sample)
TREE_DEPTH = min(leaf_depths(E3_TREE))


def encode(image: np.ndarray, cfg: dict) -> bytes:
    return encode_modular_advanced(image, options=AdvancedOptions(tree=E3_TREE, **cfg["encoder"]))


def reference(image: np.ndarray, cfg: dict, device="cpu") -> torch.Tensor:
    h, w = image.shape[:2]
    out = torch.full((h, w, 4), 255, dtype=torch.uint8)
    out[..., :3] = torch.from_numpy(np.ascontiguousarray(image[..., :3]))
    return out.to(device)


def control(image: np.ndarray, cfg: dict, device="cpu") -> torch.Tensor:
    out = reference(image, cfg, device)
    out[..., :3] &= 0xFE
    return out


def compare(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The numbers compared for one answer: samples that differ (RGBA), and
    the largest gap in levels."""
    d = (out.to(torch.int16) - ref.to(torch.int16).to(out.device)).abs()
    return {"mismatch_samples": int((d > 0).sum()), "max_diff": int(d.max())}
