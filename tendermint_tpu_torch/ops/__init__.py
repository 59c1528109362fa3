"""Field arithmetic, the verify pipeline and the CUDA kernels' bindings."""
