"""The benchmark of j40_tpu_torch on one CUDA card; see README.md."""
