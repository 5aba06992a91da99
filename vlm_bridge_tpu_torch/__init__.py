"""PyTorch / CUDA port of vlm_bridge_tpu for one NVIDIA H100.

Module paths and public names mirror `vlm_bridge_tpu`; the decode kernels
are hand-written CUDA C++ for sm_90a (`csrc/`), each with a plain PyTorch
version beside its wrapper. The port imports torch and never jax; the two
jax-free modules `vlm_bridge_tpu.configs` and `vlm_bridge_tpu.data.tokenizer`
are imported, not copied.
"""
