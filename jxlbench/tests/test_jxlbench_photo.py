"""The configuration photo_d05e7 and its cell photo_d05e7.camera12mp_c2 at
sizes a test run holds, on the CPU: the new files load and keep to the
contract's shapes; the frozen VarDCT encoder writes cjxl's restoration
filter and the same tokens its vectorized collector and the port's
encoder make; the port decodes its streams to the plain reference; each
control fails the limits; and a whole small run of the cell is correct,
and not correct under each fault and each control put under the timed
path."""

import functools
import time

import numpy as np
import pytest
import torch

from jxlbench import faults, run, spec
from jxlbench.frozen_vardct import vardct_enc as V
from jxlbench.images import camera

BENCH = spec.load_benchmark()
CELL = "photo_d05e7.camera12mp_c2"
CFG = spec.load_json(spec.PKG / "configs" / "photo_d05e7.json")
CODEC = spec.load_module(spec.PKG / "configs" / "photo_d05e7.py")
#: two LF groups one above the other; the host's entropy (the card's HF
#: route has only its slow plain version here)
SMALL = {"image": {"height": 2304, "width": 256}, "entry_args": {
    "backend": "torch", "workers": 4, "apply_filters": True}}
SEED = 2**31 + 4099


def passes(nums) -> bool:
    return all(nums[k] <= lim for k, lim in CFG["limits"].items())


def test_the_files_keep_to_the_contract():
    cell = spec.load_cell(BENCH, CELL)
    assert cell.chips == 1 and cell.width * cell.height == 4096 * 3072
    new = {"vardct_hf_host_ms.camera", "vardct_gather_ms.camera", "filters_ms.camera",
           "B9_roofline", "B2_roofline"}
    assert new <= {m.name for m in cell.metrics}
    for m in BENCH["per_layer"]:
        if m["name"] in new:
            assert m["workloads"] == [CELL] and m["moves"] == "mpix_s"
    assert cell.workload["entry_args"] == {"backend": "device", "workers": 4,
                                           "apply_filters": True}
    assert cell.workload["traffic"] == {"loop": "closed", "clients": 2}
    assert cell.workload["corpus"] == 2 and cell.workload["sample"]["share"] == 1.0
    entry = next(c for c in BENCH["configs"] if c["name"] == "photo_d05e7")
    assert len(entry["source"]) <= 200 and entry["reduced"] == CFG["reduced"] == []
    assert set(CODEC.CONTROLS) == {"no_gaborish", "lf_group_gaborish", "bf16_idct"}
    assert CODEC.control is CODEC.CONTROLS["bf16_idct"]


@functools.lru_cache(maxsize=None)
def _stream(h, w, index=0):
    img = camera.make(h, w, SEED, index)
    return img, CODEC.choose(img, CFG), CODEC.encode(img, CFG)


def test_cjxl_restoration_filter_and_the_tokens():
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode import vardct_enc as PV

    img, ch, data = _stream(256, 320)
    dec = Decoder(data, backend="numpy")
    dec.decode_frame()
    f = dec.frame.header
    assert f.gab_enabled and f.epf_iters == 0 and f.skip_adapt_lf_smooth
    assert f.gab_weights == [[0.115169525, 0.061248592]] * 3
    # the vectorized collector and the scalar one write the same stream
    # (the scalar one runs where a varblock has its own HF multiplier)
    scalar = V.synthesize_vardct(ch.width, ch.height, ch.grid, ch.lf_int, ch.tokens,
                                 options=ch.options, hfmul_per_vb=[ch.options.hf_mul]
                                 * len(ch.tokens))
    assert scalar == data
    # and the port's encoder, whose restoration filter is all_default
    opt = PV.VarDCTOptions(use_prefix=False, hf_mul=CFG["encoder"]["hf_mul"])
    port = PV.encode_vardct_mixed(img, opt, CFG["encoder"]["t16"], CFG["encoder"]["t32"])
    ours = V.encode_vardct_mixed(img, V.VarDCTOptions(use_prefix=False,
                                                      hf_mul=CFG["encoder"]["hf_mul"]),
                                 CFG["encoder"]["t16"], CFG["encoder"]["t32"])
    assert port == ours
    sels = {s for _, _, s in ch.placements}
    assert 0 in sels and sels & {4, 5, 6, 7}


@pytest.mark.parametrize("sel", [0, 4, 5, 6, 7])
def test_the_frozen_encoders_dequant_tables_are_the_references(sel):
    """The frozen encoder quantizes with the default tables the reference
    computes from the format's parameters."""
    from jxlbench import photo_reference as R
    from jxlbench.frozen_vardct.vardct.tables import DCT_SELECT

    lr, lc, param_idx, _ = DCT_SELECT[sel]
    np.testing.assert_allclose(V._default_dq64(param_idx)[: 1 << (lr + lc)],
                               R.default_weights((lr, lc), "cpu").numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("size", [(256, 320), (2304, 256), (61, 77)])
def test_port_decodes_to_the_reference(size):
    from j40_tpu_torch import decode_file

    img, ch, data = _stream(*size)
    ref = CODEC.reference(img, CFG)
    assert ref.shape == (*size, 4) and ref.dtype == torch.uint8
    _, rgba = decode_file(data, backend="torch", device="cpu", workers=4, apply_filters=True)
    nums = CODEC.compare(torch.from_numpy(rgba), ref)
    assert passes(nums), nums
    _, plain = decode_file(data, backend="torch", device="cpu", workers=4)
    assert not passes(CODEC.compare(torch.from_numpy(plain), ref))


@pytest.mark.parametrize("control", sorted(CODEC.CONTROLS))
def test_each_control_fails(control):
    img, _, _ = _stream(2304, 256)
    nums = CODEC.compare(CODEC.CONTROLS[control](img, CFG), CODEC.reference(img, CFG))
    assert not passes(nums), nums


def test_camera_content_is_seeded():
    a, b = camera.make(64, 96, 5, 0), camera.make(64, 96, 6, 0)
    assert a.shape == (64, 96, 3) and a.dtype == np.uint8
    assert not np.array_equal(a, b)
    assert np.array_equal(a, camera.make(64, 96, 5, 0))


def small_run(fault=None, seconds=3.0):
    cell = spec.load_cell(BENCH, CELL, overrides=SMALL)
    return run.run_cell(cell, SEED, seconds, False, device="cpu", t_start=time.perf_counter(),
                        overrides=SMALL, fault=fault)


CASES = {"clean": None, "altered": faults.altered, "stale": faults.stale,
         **{name: "control" for name in CODEC.CONTROLS}}


@pytest.mark.parametrize("case", list(CASES))
def test_run_and_its_faults(case, monkeypatch):
    fault = CASES[case]
    if fault == "control":
        # a control in the program's place (jxlbench/controls.py's route)
        monkeypatch.setattr(CODEC, "control", CODEC.CONTROLS[case])
        cell = spec.load_cell(BENCH, CELL, overrides=SMALL)
        fault = faults.control_of(cell, SEED, "cpu")
    res = small_run(fault)
    assert res["checks"]["answers_compared"]["value"] > 0
    assert res["correct"] is (case == "clean"), res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and "mpix_s" in res["metrics"]
