"""Hand-written Hopper kernels of the port and what their wrappers share.

Each kernel module holds the CUDA wrapper (``*_cuda``), the plain PyTorch
version of the same function (``*_plain``), a dispatcher that takes the
plain version only for CPU tensors and the kernel for CUDA tensors, and a
``launches`` counter that the CUDA wrapper bumps once per launch (the two
norms' backward wrappers, ``rms_norm_backward`` and
``layer_norm_backward``, count theirs in their module's
``backward_launches``, and the two norms fused with the activation
quantizer, ``rms_norm_quant`` and ``layer_norm_quant``, in their module's
``quant_launches``).  A call recorded into a CUDA graph launches nothing:
the graph (``models/graphs.py``) takes the counts its capture added back
off with :func:`set_launch_counts` and credits them on every replay with
:func:`credit_launches`.
"""
from __future__ import annotations

import ctypes
import functools
import importlib

import torch

KERNELS = ("int8_matmul", "int8_matmul_grouped", "pim_mvm", "decode_attn",
           "verify_attn", "verify_tree_attn", "ssd_chunk", "rms_norm", "rms_norm_quant",
           "layer_norm", "layer_norm_quant", "rms_norm_backward", "layer_norm_backward")

# (module, attribute) of the counts that are not their module's ``launches``
_COUNTERS = {"rms_norm_quant": ("rms_norm", "quant_launches"),
             "layer_norm_quant": ("layer_norm", "quant_launches"),
             "rms_norm_backward": ("rms_norm", "backward_launches"),
             "layer_norm_backward": ("layer_norm", "backward_launches")}


def _counter(name: str) -> tuple:
    """(module, attribute) of a kernel's launch count."""
    mod, attr = _COUNTERS.get(name, (name, "launches"))
    return importlib.import_module(f"repro_torch.kernels.{mod}"), attr


def launch_counts() -> dict[str, int]:
    return {name: getattr(*_counter(name)) for name in KERNELS}


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(KERNELS, 0))


def set_launch_counts(counts: dict[str, int]) -> None:
    for name in KERNELS:
        setattr(*_counter(name), counts[name])


def credit_launches(delta: dict[str, int]) -> None:
    """Add the launches of one replayed graph to the counters."""
    for name, n in delta.items():
        mod, attr = _counter(name)
        setattr(mod, attr, getattr(mod, attr) + n)


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


_tickets: dict = {}


def tickets(device: torch.device, kernel: str, n: int) -> torch.Tensor:
    """The int32 [n] ticket array of ``kernel`` on ``device``: made zero
    once, outside any CUDA graph capture, and kept, so that a captured call
    and its replays use the same one; the kernel that counts on it sets
    every ticket back to zero before it ends."""
    key = (kernel, device.index)
    t = _tickets.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}: call it once outside a CUDA graph capture on "
                               f"this device before capturing it (it makes its tickets)")
        t = _tickets[key] = torch.zeros((n,), dtype=torch.int32, device=device)
    if t.numel() < n:
        raise ValueError(f"{kernel}: {n} tickets asked, {t.numel()} made")
    return t


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
