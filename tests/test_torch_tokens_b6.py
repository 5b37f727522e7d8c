"""The port's token packer and plain decoder (ops/token_kernels.py,
ops/device_entropy.py decode_tokens_ctx: the plain version of the CUDA
kernel B6) against j40_tpu's Pallas kernel B6 itself, run in interpret
mode with its test configuration, on B6's own case: lanes sharing one
single-cluster spec.  Values, final rANS states and final bit positions
must be EQUAL (streams and checks of tests/test_torch_tokens.py).
"""

import numpy as np
import pytest

from j40_tpu.ops import pallas_entropy as JPE
from j40_tpu_torch.entropy.hybrid import HybridIntConfig
from j40_tpu_torch.ops import token_kernels as TKN
from j40_tpu_torch.ops.hf_kernels import to_device
from test_torch_tokens import _check, _same, _values, make_lanes


@pytest.mark.parametrize("use_prefix,n_lanes,n_vals", [
    (True, 5, 61), (True, 1, 23), (True, 3, 49), (False, 3, 49)],
    ids=["prefix-5x61", "prefix-1x23", "prefix-3x49", "ans-3x49"])
def test_plain_matches_pallas_interpret(use_prefix, n_lanes, n_vals):
    """B6's own case, one spec shared by every lane: the port's packer and
    plain version against j40_tpu's Pallas kernel in interpret mode (its
    test configuration) at the sizes of tests/test_pallas_entropy.py.  The
    rANS kernel takes far longer to interpret than the prefix one, so it
    runs at the size that crosses its segment boundary (the scan tests of
    tests/test_torch_tokens.py cover rANS at other sizes)."""
    rng = np.random.default_rng(7 + n_lanes)
    lanes = [_values(rng, n_vals, "tail" if n_lanes != 3 else "small")
             for _ in range(n_lanes)]
    streams, specs, jspecs, host, ends = make_lanes(lanes, use_prefix, shared=True,
                                                    config=HybridIntConfig(4, 1, 0))
    assert JPE.spec_is_pallas_simple(jspecs[0])
    nsym = [len(v) for v in lanes]
    want = JPE.decode_tokens_pallas(streams, nsym, jspecs[0], n_vals, cfg=JPE.TEST_CFG)
    _check(*want, host, ends, streams, use_prefix)
    d = TKN.build_lane_inputs(streams, nsym, specs)
    assert d["sym"].shape[0] == 1 and not d["rows"].any()  # one shared row
    _same(TKN.launch_tokens(to_device(d, "cpu")), want)


