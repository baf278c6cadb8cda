"""PyTorch integer pixel ops of the HEVC picture decode.

Each module mirrors its namesake in ``libde265_tpu.ops`` (same constants,
same function boundaries, bit-exact results).  The ``*_cuda`` modules and
``intra_window`` (the counterpart of ``intra_window_pallas``) hold the
wrappers of the hand-written Hopper kernels (``../csrc``): a CPU tensor
runs the plain PyTorch version, a CUDA tensor launches the kernel.
"""
