"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def check(name: str, device, dtype, *tensors):
    """Every tensor must lie on `device`, have `dtype` and be contiguous."""
    for i, t in enumerate(tensors):
        if t.device != device:
            raise ValueError(f"{name}: argument {i} on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")


def stream_of(t: torch.Tensor) -> int:
    """The current stream's cudaStream_t on t's device, the value of
    torch.cuda.current_stream(t.device).cuda_stream, read without building
    a torch.cuda.Stream object (tests/test_torch_mc_seg.py holds the two
    equal, on the default stream and inside a side stream)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
