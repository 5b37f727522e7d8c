"""One wavefront launch a (class, kernel): the Modular device route
(ops/device_modular.py) sends the slots of a class that share a shape and a
kernel as one batch of planes, on the seven Modular streams of PERF.md §4
(chip_smoke.modular_stream's trees and options) at a small size, through
`Decoder(data, backend="device", device="cpu")`.

Each stream's RGBA must EQUAL the port's host plan and j40_tpu's; the
route's counts: `reconstructions` one a (class, slot), `wavefronts` one a
(class, shape, kernel), which this test derives from the lane plan by the
rule in the route's docstrings.  Streams are 16 rows of 264 columns in
128-pixel groups: two lane shapes, so two classes a batch.
"""

import numpy as np
import pytest

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu_torch.decode import Decoder as TDecoder
from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
from j40_tpu_torch.encode.encoder import EncodeOptions, encode_modular
from j40_tpu_torch.encode.modular_enc import branch, leaf
from j40_tpu_torch.ops import device_modular as DM
from j40_tpu_torch.ops import kernels as TK

E3 = [branch(15, 0, 1, 2), leaf(6), leaf(5)]
STATIC = [branch(0, 0, 1, 2), branch(3, 60, 3, 4), branch(2, 10, 5, 6), leaf(5), leaf(1),
          leaf(2), branch(1, 25, 7, 8), leaf(0), leaf(5, offset=3)]
STATIC_WP = [branch(0, 0, 1, 2), branch(3, 70, 3, 4), branch(2, 10, 5, 6), leaf(6), leaf(4),
             leaf(7), leaf(12)]
#: name -> (tree or None for encode_modular, options)
STREAMS = {
    "modular": (None, {}),
    "modular_global": (None, dict(global_tree=True)),
    "modular_e3": (E3, {}),
    "modular_e3gt": (E3, dict(use_prefix=False, global_tree=True)),
    "modular_static_ctx": (STATIC, dict(use_prefix=False, complex_cluster_map=True)),
    "modular_wp": ([leaf(6)], {}),
    "modular_static_wp": (STATIC_WP, {}),
}


def _stream(name) -> bytes:
    rng = np.random.default_rng(11)
    img = (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(16, 264, 3)), 0), 1)
           % 256).astype(np.uint8)
    tree, kw = STREAMS[name]
    if tree is None:
        return encode_modular(img, options=EncodeOptions(group_size_shift=7, **kw))
    return encode_modular_advanced(img, options=AdvancedOptions(tree=tree, group_size_shift=7,
                                                                **kw))


def _decode(cls, data, **kw):
    dec = cls(data, **kw)
    while not dec.done:
        dec.decode_frame()
    return dec, dec.render_rgba8()


def _kernel(members, slot):
    """The wavefront a class's slot takes (None: a cumsum or nothing)."""
    lane = members[0]
    if lane.ntree is not None:
        return "tree"
    if lane.ctx is None:
        return {5: "gradient", 6: "wp"}.get(lane.leaf.predictor)
    pred = np.stack([ln.ctx[slot]["pred"] for ln in members])
    if lane.wp is not None and not np.isin(pred, (0, 1, 2, 5)).all():
        return "wp_codes"
    if (pred != pred.flat[0]).any():
        return "mixed"
    return "gradient" if pred.flat[0] == 5 else None


def _counts(data) -> tuple[int, int]:
    """(reconstructions, wavefronts) of the route's rule: a class is the
    lanes of one batch (coder, kind) that share their leaf or tree, WP
    parameters and slot shapes; a launch is a class's slots of one shape
    and one kernel (a static tree's slot picks it over the class's lanes)."""
    dec = TDecoder(data, backend="numpy", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    _, toc, state = dec._deferred
    lanes = DM.plan_lanes(dec, state, [s for s in toc.sections if s.pass_ == 0])
    classes: dict = {}
    for ln in lanes:
        shapes = tuple((w, h) for (_, _, _, w, h) in ln.picks)
        leafkey = ((ln.leaf.predictor, ln.leaf.multiplier, ln.leaf.offset)
                   if ln.ctx is None and ln.ntree is None else None)
        key = (ln.spec.use_prefix_code, ln.ctx is not None, ln.ntree and ln.ntree[0],
               leafkey, ln.wp, shapes)
        classes.setdefault(key, []).append(ln)
    recon = launches = 0
    for key, members in classes.items():
        shapes = key[-1]
        recon += len(shapes)
        kinds = [_kernel(members, slot) for slot in range(len(shapes))]
        launches += len({(shape, kind) for shape, kind in zip(shapes, kinds) if kind})
    return recon, launches


@pytest.mark.parametrize("name", list(STREAMS))
def test_one_wavefront_launch_a_class_and_kernel(name):
    data = _stream(name)
    TK.reset_launches()
    dec, got = _decode(TDecoder, data, backend="device", device="cpu")
    assert not any(TK.launches.values()), TK.launches  # plain versions on the CPU
    _, host = _decode(TDecoder, data, backend="numpy")
    np.testing.assert_array_equal(got, host)
    _, jhost = _decode(JDecoder, data, backend="numpy")
    np.testing.assert_array_equal(got, jhost)

    dm = dec.stats["device_modular"]
    recon, launches = _counts(data)
    assert dm["reconstructions"] == recon
    assert dm["wavefronts"] == launches > 0
    if not name.startswith("modular_static"):
        # three channels of one shape a class: a launch for three slots
        assert dm["reconstructions"] == 3 * dm["wavefronts"]
