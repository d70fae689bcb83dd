"""Command-line entry points (pram_tpu/cli)."""
