"""PyTorch/CUDA port of vitcap_tpu for NVIDIA Hopper (H100).

Same structure and names as the JAX package: models/{config,layers,vitcap,
decode}.py, ops/ (hand-written CUDA kernels under csrc/, each with its plain
PyTorch version), solver/checkpoint_bridge.py, serving.py.  Imports torch,
never jax.
"""
