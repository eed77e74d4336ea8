"""Data parallelism: the device mesh and FSDP (port of bitdance_tpu/parallel)."""
