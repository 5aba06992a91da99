"""PyTorch / CUDA port of vlm_bridge_tpu for one NVIDIA H100.

Module paths and public names mirror `vlm_bridge_tpu`; the kernels
are hand-written CUDA C++ for sm_90a (`csrc/`), each with a plain PyTorch
version beside its wrapper. The port imports torch, never jax, and nothing
of `vlm_bridge_tpu`: `configs` and `data.tokenizer` are its own copies, held
equal to the JAX package's by the tests.
"""
