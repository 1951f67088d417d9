"""PyTorch/CUDA port of the FV3 cubed-sphere dynamical core.

Counterpart of gfdl_atmos_cubed_sphere_tpu (the JAX reference). Imports
torch and numpy, never jax. Entry points take a `device` and run on the
CUDA card unless the caller asks for the CPU.
"""
