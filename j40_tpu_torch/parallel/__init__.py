"""Multi-image decode on the device (counterpart of j40_tpu/parallel)."""
