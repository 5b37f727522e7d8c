"""A frozen copy of the port's VarDCT encoder, so that the lossy cells'
inputs stay the same whatever later changes make to the program:
`vardct_enc.py` from j40_tpu_torch/encode/ and the tables it needs from
j40_tpu_torch/vardct/ (`dct.py`, `dequant.py`, `order.py`, `tables.py`),
taken at commit a36605aafbd84b1b4c08421f5d9d7440bc29349c.  Their imports
are relative and stay inside jxlbench: the rest of the encoder and the
host modules are jxlbench/frozen/'s.  It lives outside frozen/ because
corpus._key hashes every file under frozen/, and a file added there would
change the other cells' corpus keys.

Additions to `vardct_enc.py`, each marked "frozen copy" there:
- `VarDCTOptions.cjxl_restoration`: the RestorationFilter cjxl writes for
  a VarDCT frame at -d 0.5 -e 7 (not all_default, gaborish on with the
  default weights, no EPF), written by `_write_vardct_frame_header`;
- `MixedChoice`, `choose_mixed` and `encode_choice`: the mixed encoder's
  choices (the quantized LF, the varblocks, their quantized coefficients)
  handed to a reference, and the stream made from them;
  `encode_vardct_mixed` is the two in turn; its forward DCTs are matmuls,
  those of a varblock class at once;
- `_collect_group_tokens_vec`: the HF tokens of a group of mixed
  varblocks, made with numpy, the same as `_collect_group_tokens_generic`,
  for the default block context and orders.
Other lines differ from that commit only in their imports."""
