"""Host-side utilities: image ops, visualization (pram_tpu/utils)."""
