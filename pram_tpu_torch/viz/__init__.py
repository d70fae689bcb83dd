"""The browser 3D viewer (pram_tpu/viz)."""

from pram_tpu_torch.viz.server import ViewerServer  # noqa: F401
