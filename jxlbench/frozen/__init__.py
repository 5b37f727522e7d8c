"""A frozen copy of the port's encoder (j40_tpu_torch/encode/) and the
numpy-only host modules it imports, so that the benchmark's inputs stay the
same whatever later changes make to the program.  See jxlbench/README.md
for the commit it was taken from and the two lines that differ."""
