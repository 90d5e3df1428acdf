"""Hand-written Hopper kernels of the port and what their wrappers share.

Each kernel module holds the CUDA wrapper (``*_cuda``), the plain PyTorch
version of the same function (``*_plain``), a dispatcher that takes the
plain version only for CPU tensors and the kernel for CUDA tensors, and a
``launches`` counter that the CUDA wrapper bumps once per launch.  A call
recorded into a CUDA graph launches nothing: the graph
(``models/graphs.py``) takes the counts its capture added back off with
:func:`set_launch_counts` and credits them on every replay with
:func:`credit_launches`.
"""
from __future__ import annotations

import ctypes
import functools
import importlib

import torch

KERNELS = ("int8_matmul", "pim_mvm", "decode_attn", "verify_attn",
           "verify_tree_attn", "ssd_chunk", "rms_norm", "layer_norm")


def _module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def launch_counts() -> dict[str, int]:
    return {name: _module(name).launches for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _module(name).launches = 0


def set_launch_counts(counts: dict[str, int]) -> None:
    for name in KERNELS:
        _module(name).launches = counts[name]


def credit_launches(delta: dict[str, int]) -> None:
    """Add the launches of one replayed graph to the counters."""
    for name, n in delta.items():
        _module(name).launches += n


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; a mix raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs span devices {sorted(kinds)}")


def require(tensor: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple[int, ...]) -> None:
    """Raise unless ``tensor`` lies on a CUDA device with exactly the dtype,
    shape and contiguous layout a kernel takes."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{tensor.device}")
    if tensor.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
