"""The modular device lanes on MA-tree streams: static-property trees
(per-token clusters, per-pixel predictor/offset/multiplier), neighbour-
property trees (the in-wavefront tree walk) and the self-correcting
predictor, through `Decoder(data, backend="device", device="cpu")`.

Each stream's RGBA must EQUAL the port's host plan and j40_tpu's
`backend="device"` and `backend="numpy"`, and its lane counts j40_tpu's
(`check_route` of tests/test_torch_modular_device.py).  Streams are small
versions of tests/test_device_modular.py's.
"""

import numpy as np
import pytest

from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
from j40_tpu_torch.encode.modular_enc import branch, leaf
from j40_tpu_torch.modular.wp import WPParams
from test_torch_modular_device import _adv, check_route

#: tests/test_device_modular.py:133-143
STATIC_TREE = [branch(0, 0, 1, 2), branch(3, 60, 3, 4), branch(2, 10, 5, 6), leaf(5),
               leaf(1), leaf(2), branch(1, 25, 7, 8), leaf(0), leaf(5, offset=3)]
#: tests/test_device_modular.py:238-246, rows cut to the image
WP_STATIC_TREE = [branch(0, 0, 1, 2), branch(3, 70, 3, 4), branch(2, 10, 5, 6),
                  leaf(6), leaf(4), leaf(7), leaf(12)]
#: tests/test_device_modular.py:169-177 (neighbour properties 7, 15, 8)
NTREES = {
    "w_branch": [branch(7, 0, 1, 2), leaf(5), leaf(1)],
    "e3_wp": [branch(15, 0, 1, 2), leaf(6), leaf(5)],
    "mixed": [branch(0, 0, 1, 2), branch(8, 3, 3, 4), leaf(5), leaf(2), leaf(1)],
}


def _offset_multiplier():
    """tests/test_device_modular.py:201-229: leaf offset and multiplier on
    a static tree, with data whose residuals they represent exactly."""
    rng = np.random.default_rng(23)
    img = np.empty((16, 200, 3), np.uint8)
    for g0 in (0, 128):
        w = min(200, g0 + 128) - g0
        right = max(0, w - 61)
        img[:, g0 + 61 : g0 + w] = rng.integers(0, 64, (16, right, 3)) * 4
        img[:, g0 : g0 + min(61, w)] = rng.integers(0, 127, (16, min(61, w), 3)) * 2 + 2
    tree = [branch(3, 60, 1, 2), leaf(0, multiplier=4), leaf(0, offset=2, multiplier=2)]
    return encode_modular_advanced(img, options=AdvancedOptions(tree=tree,
                                                                group_size_shift=7))


# name -> (stream, the stats key that must count lanes)
STREAMS = {
    "static_tree_prefix": (_adv(STATIC_TREE, seed=17), "ctx_lanes"),
    "static_tree_ans_complex_map": (_adv(STATIC_TREE, seed=17, use_prefix=False,
                                         complex_cluster_map=True), "ctx_lanes"),
    **{f"ntree_{k}": (_adv(t, seed=19), "ntree_lanes") for k, t in NTREES.items()},
    "ntree_e3_ans_global": (_adv(NTREES["e3_wp"], seed=19, use_prefix=False,
                                 global_tree=True), "ntree_lanes"),
    "wp_leaf_prefix": (_adv([leaf(6)], seed=29), "lanes"),
    "wp_leaf_ans": (_adv([leaf(6)], seed=29, use_prefix=False), "lanes"),
    "wp_custom_params": (_adv([leaf(6)], seed=31, wp_params=WPParams(
        p1=9, p2=14, p3=(2, 11, 5, 1, 3), w=(11, 13, 14, 12))), "lanes"),
    "wp_in_static_tree": (_adv(WP_STATIC_TREE, seed=37), "ctx_lanes"),
    "offset_multiplier": (_offset_multiplier, "ctx_lanes"),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_tree_route_matches_host_and_jax(name):
    make, key = STREAMS[name]
    check_route(make(), key)
