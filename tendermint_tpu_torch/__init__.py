"""PyTorch/CUDA port of tendermint_tpu's batched ZIP-215 verification path.

The package mirrors ``tendermint_tpu``'s layout (``crypto/``, ``ops/``,
``types/``, ``wire/``) and imports nothing from it: each module here is a
trimmed copy of its counterpart there, kept to what commit verification
needs.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU the hand-written kernels' plain PyTorch
versions run instead.
"""
