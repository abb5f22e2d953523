"""PyTorch/CUDA port of lightning_generative_models_tpu for NVIDIA Hopper (H100).

Module paths mirror the JAX package. Each TPU (Pallas) kernel on a ported path is a
CUDA C++ kernel under ``csrc/``, built with nvcc at first use; each has a plain
PyTorch version that CPU tensors take. Entry points run on the GPU unless the caller
asks for the CPU.
"""
