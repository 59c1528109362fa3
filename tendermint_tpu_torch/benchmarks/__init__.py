"""The port's device probes, counterparts of the JAX package's
``benchmarks/``: ``roofline_probe`` (chains of one operation per pipe, the
two Pallas probes as CUDA kernels, the op census and the roofline line),
``kernel_bench`` (the raw verify kernel of each layout) and ``rlc_bench``
(the RLC kernel and fold against the per-row kernel).  Each runs on
``cuda`` unless given ``--device cpu``, which runs the plain versions,
and prints one JSON line per result with the original tool's keys."""
