"""The frozen encoder, the plain references and the controls, at sizes a
test run holds, on the CPU: the port decodes the frozen encoder's streams to
what the references work out, and each control fails its limits."""

import numpy as np
import pytest
import torch

from jxlbench import spec
from jxlbench.images import photo

BENCH = spec.load_benchmark()
CONFIGS = {c["name"]: spec.load_json(spec.ROOT / c["file"]) for c in BENCH["configs"]}
CODECS = {n: spec.load_module(spec.PKG / "configs" / f"{n}.py") for n in CONFIGS}
SIZES = [(64, 80), (72, 300), (37, 53)]


def passes(name, nums):
    return all(nums[k] <= lim for k, lim in CONFIGS[name]["limits"].items())


def test_the_e3_tree_is_libjxls_fixed_wp_tree():
    codec = CODECS["lossless_e3"]
    tree = codec.E3_TREE
    branches = [n for n in tree if not n.is_leaf]
    assert len(tree) == 67 and len(branches) == 33
    assert {n.prop for n in branches} == {15}
    assert {n.predictor for n in tree if n.is_leaf} == {6}
    assert sorted(n.value for n in branches) == list(codec.WP_CUTOFFS)
    assert tree[0].value == 0 and (tree[1].value, tree[2].value) == (47, -31)
    # breadth first: the children of the k-th branch are nodes 2k + 1, 2k + 2
    assert [(n.left, n.right) for n in branches] == [(2 * k + 1, 2 * k + 2) for k in range(33)]
    assert sorted(codec.leaf_depths(tree)) == [5] * 30 + [6] * 4
    assert codec.TREE_DEPTH == 5
    assert CONFIGS["lossless_e3"]["encoder"]["rct_type"] == 6


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_decodes_to_the_reference(name, size):
    from j40_tpu_torch import decode_file

    img = photo.make(*size, 2**31 + 77, 1)
    codec, cfg = CODECS[name], CONFIGS[name]
    data = codec.encode(img, cfg)
    ref = codec.reference(img, cfg)
    assert ref.shape == (*size, 4) and ref.dtype == torch.uint8
    for backend in ("torch", "numpy"):
        _, rgba = decode_file(data, backend=backend, device="cpu")
        nums = codec.compare(torch.from_numpy(rgba), ref)
        assert passes(name, nums), (backend, nums)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_control_fails(name):
    codec, cfg = CODECS[name], CONFIGS[name]
    for seed in (1, 2, 2**31 + 3):
        img = photo.make(72, 96, seed, 0)
        nums = codec.compare(codec.control(img, cfg), codec.reference(img, cfg))
        assert not passes(name, nums), nums


def test_photo_density_is_the_same_for_every_seed():
    codec, cfg = CODECS["lossless_e3"], CONFIGS["lossless_e3"]
    sizes = [len(codec.encode(photo.make(96, 96, s, 3), cfg)) for s in (5, 6, 2**31 + 1)]
    assert max(sizes) / min(sizes) < 1.05
    a, b = photo.make(64, 64, 5, 0), photo.make(64, 64, 6, 0)
    assert not np.array_equal(a, b)
    assert np.array_equal(a, photo.make(64, 64, 5, 0))
