"""photo_d05e7's stream and its plain reference.

The stream is the frozen mixed VarDCT encoder's (jxlbench/frozen_vardct/)
in the shape cjxl -d 0.5 -e 7 writes for a photo: DCT8 varblocks in detail,
DCT16x16, DCT32x32, DCT16x8 and DCT8x16 where the image is smooth
(libjxl's lib/jxl/enc_ac_strategy.cc merges smooth regions), and a
RestorationFilter with gaborish on and no EPF (lib/jxl/enc_frame.cc turns
gaborish on at effort 5 and above and EPF on only from distance 0.7).

The reference is the format's reconstruction of what the encoder chose
(`choose_mixed`), in float64 (jxlbench/photo_reference.py): LF and HF
dequantization, chroma from luma, the LLF of large varblocks from the LF,
each varblock's inverse DCT, gaborish over the whole frame, XYB to 8-bit
sRGB.

`compare` gives the share of the RGB samples that differ from the
reference at all, in percent (`mismatch_pct`: a share, so that one limit
holds at every frame size), and the largest gap in levels (`max_diff`);
the limits and their reasons are in the configuration's JSON and in
PERF.md.
Three controls put another reconstruction in the program's place, each a
fault the limits have to catch (`CONTROLS`): the frame without gaborish,
gaborish on each 2048x2048 LF group apart with its edges repeated at every
LF-group border (the decode before whole-frame filtering), and the inverse
DCTs at bfloat16, the precision below the float32 the program states
(`control`, the one `python3 -m jxlbench.control` runs)."""

from __future__ import annotations

import numpy as np
import torch

from jxlbench import photo_reference as R
from jxlbench.frozen.headers.frame import FrameHeader
from jxlbench.frozen.headers.image import (
    OPSIN_BIAS, OPSIN_INV_MAT, QUANT_BIAS, QUANT_BIAS_NUM,
)
from jxlbench.frozen_vardct import vardct_enc as V
from jxlbench.frozen_vardct.vardct.tables import DCT_SELECT, QM_SCALE

#: the frozen encoder's frame settings: x_qm_scale 3, b_qm_scale 2; the
#: default LfChannelCorrelation (kx 0, kb 1 for LF and HF alike)
X_QM, B_QM = 3, 2
KX, KB = 0.0, 1.0


def options(cfg: dict) -> V.VarDCTOptions:
    enc = {k: v for k, v in cfg["encoder"].items() if k not in ("t16", "t32")}
    return V.VarDCTOptions(**enc)


def choose(image: np.ndarray, cfg: dict) -> V.MixedChoice:
    return V.choose_mixed(image, options(cfg), cfg["encoder"]["t16"], cfg["encoder"]["t32"])


def encode(image: np.ndarray, cfg: dict) -> bytes:
    return V.encode_choice(choose(image, cfg))


def inputs(ch: V.MixedChoice) -> dict:
    """The reference's inputs (photo_reference.reconstruct) from the
    encoder's choices and the settings it wrote; the dequant weights are
    not among them: the reference computes the format's default tables,
    which the stream signals."""
    opt = ch.options
    if opt.custom_dq:
        raise ValueError("the reference takes the default dequant tables only")
    sels = np.array([s for _, _, s in ch.placements], np.int64)
    ys = np.array([y for y, _, _ in ch.placements], np.int64)
    xs = np.array([x for _, x, _ in ch.placements], np.int64)
    varblocks = {}
    for sel in np.unique(sels):
        lr, lc, _, _ = DCT_SELECT[int(sel)]
        idx = np.flatnonzero(sels == sel)
        varblocks[(lr, lc)] = dict(
            y8=ys[idx], x8=xs[idx],
            q=np.stack([np.stack(ch.tokens[i]) for i in idx]))
    header = FrameHeader()
    return dict(
        width=ch.width, height=ch.height, lf_int=ch.lf_int, varblocks=varblocks,
        m_lf_scaled=list(opt.m_lf_scaled or header.m_lf_scaled),
        global_scale=opt.global_scale, quant_lf=opt.quant_lf, hf_mul=opt.hf_mul,
        qm_scales=[QM_SCALE[X_QM], 1.0, QM_SCALE[B_QM]],
        quant_bias=list(QUANT_BIAS), quant_bias_num=QUANT_BIAS_NUM,
        kx_lf=KX, kb_lf=KB, kx_hf=KX, kb_hf=KB,
        gab_weights=header.gab_weights if opt.cjxl_restoration else None,
        opsin_inv_mat=OPSIN_INV_MAT, opsin_bias=OPSIN_BIAS, intensity_target=255.0)


def reference(image: np.ndarray, cfg: dict, device="cpu") -> torch.Tensor:
    return R.reconstruct(inputs(choose(image, cfg)), device)


def no_gaborish(image: np.ndarray, cfg: dict, device="cpu") -> torch.Tensor:
    return R.reconstruct(inputs(choose(image, cfg)), device, gaborish_mode="none")


def lf_group_gaborish(image: np.ndarray, cfg: dict, device="cpu") -> torch.Tensor:
    return R.reconstruct(inputs(choose(image, cfg)), device, gaborish_mode="lf_groups")


def bf16_idct(image: np.ndarray, cfg: dict, device="cpu") -> torch.Tensor:
    return R.reconstruct(inputs(choose(image, cfg)), device, idct_dtype=torch.bfloat16)


#: the controls of `correct`, each of which has to come out not correct
CONTROLS = {"no_gaborish": no_gaborish, "lf_group_gaborish": lf_group_gaborish,
            "bf16_idct": bf16_idct}
control = bf16_idct


def compare(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The numbers compared for one answer: the share of RGB samples that
    differ at all, in percent, and the largest gap in levels."""
    d = (out[..., :3].to(torch.int16) - ref[..., :3].to(torch.int16).to(out.device)).abs()
    return {"mismatch_pct": 100.0 * int((d > 0).sum()) / d.numel(), "max_diff": int(d.max())}
