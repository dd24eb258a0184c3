"""The benchmark of viprs_tpu_torch on one CUDA card (``python -m
portbench.run``; README.md). Nothing here imports JAX or the JAX package."""
