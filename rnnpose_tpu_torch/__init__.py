"""RNNPose in PyTorch (eval refinement, training, LINEMOD evaluation), with
hand-written CUDA kernels for the NVIDIA H100.

The port of the JAX package `rnnpose_tpu`, which stays the reference it is
tested against. Same subpackage layout and module names; NHWC tensors at the
public functions. Importing the package builds nothing: each CUDA kernel is
compiled on its first launch.
"""
