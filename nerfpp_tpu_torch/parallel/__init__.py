"""Data parallelism of the port (the counterpart of nerfpp_tpu/parallel)."""
