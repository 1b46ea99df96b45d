"""Port of `slowfast_vos_tpu.models`."""
