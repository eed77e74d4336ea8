"""See the module of the same name in bitdance_tpu."""
