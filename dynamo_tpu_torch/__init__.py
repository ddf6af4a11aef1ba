"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu, for NVIDIA Hopper.

It imports torch and never jax, and nothing of the dynamo_tpu package: the
JAX package is the reference the port is held against in the tests.
"""
