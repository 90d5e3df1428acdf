"""W8A8 quantization + QLC nibble packing (Sec. IV-A, SmoothQuant [15]).

PyTorch counterpart of ``repro.core.quant``.  The paper stores 8-bit weights
across **two QLC cells** (4 bits each) and recombines them with a
shift-adder:

  w_int8 = hi * 16 + lo,   hi = w >> 4  (signed 4-bit, [-8, 7])
                           lo = w & 15  (unsigned 4-bit, [0, 15])

Activations are quantized dynamically per token (symmetric int8).  Every
integer stage is bit-exact with the JAX reference: ``torch.round`` and
``jnp.round`` both round half to even, the scale is ``max(amax, 1e-8)/127``
and codes clip to +-127.  The scale divides by 127 held in a tensor on
``amax``'s device (:func:`_scale`): on CUDA, PyTorch's true division by a
Python scalar multiplies by its rounded reciprocal instead, which gives
another f32 scale for about one mantissa in twenty.
"""
from __future__ import annotations

import dataclasses

import torch

INT8_MAX = 127.0
EXACT_BLOCK = 2 ** 27    # elements of b a block of exact_int_matmul
QUANT_BLOCK = 2 ** 28    # elements of w a block of quantize_weight


_DIVISORS: dict = {}     # (device, dtype) -> 0-d tensor holding 127


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division on any device.  The divisor is one
    0-d tensor a (device, dtype), made on the first call there, which must
    not be inside a CUDA-graph capture (a capture records the fill without
    running it); the serve steps' eager warm-up makes it, so a captured step
    adds no node for it and copies nothing from the host.  The training
    path's int8 quantizers (``optim/adamw.py``, ``ft/compress.py``) divide
    through it too."""
    key = (t.device, t.dtype)
    div = _DIVISORS.get(key)
    if div is None:
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quantizer divisor first made inside a CUDA-graph "
                               "capture: run the step eagerly once before capturing")
        div = _DIVISORS[key] = torch.full((), INT8_MAX, dtype=t.dtype, device=t.device)
    return t / div


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as an IEEE division on any device
    (:func:`div127`)."""
    return div127(torch.clamp_min(amax, 1e-8))


@dataclasses.dataclass
class QuantizedLinear:
    """A PIM-resident ("QLC region") linear layer: int8 weights + scales."""

    w_q: torch.Tensor                   # int8 [in, out]
    w_scale: torch.Tensor               # f32  [out]   (per-output-channel)
    smooth: torch.Tensor | None = None  # f32  [in], folded activation smoothing


def quantize_weight(w: torch.Tensor, axis: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a 2-D weight; ``axis`` is the
    contraction axis of ``w`` ([in, out] -> axis=0).  Returns (w_q int8,
    scale f32).  The weight goes in blocks of whole channels of at most
    ``QUANT_BLOCK`` elements, each channel's codes rounded and clipped in
    place in its block's f32 temporary, so quantizing the widest weight
    holds 1 GiB besides it and its int8 copy (a channel's scale and codes
    depend on that channel alone: the blocks change no bit)."""
    other = 1 - axis
    n, step = w.shape[other], max(1, QUANT_BLOCK // max(w.shape[axis], 1))
    w_q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((n,), dtype=torch.float32, device=w.device)
    for lo in range(0, n, step):
        blk = w.narrow(other, lo, min(step, n - lo))
        s = _scale(blk.abs().amax(dim=axis))
        w_q.narrow(other, lo, blk.shape[other]).copy_(
            (blk / s.unsqueeze(axis)).round_().clamp_(-127, 127))
        scale[lo:lo + s.shape[0]].copy_(s)
    return w_q, scale


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8 quantization (last axis = features)."""
    scale = _scale(x.abs().amax(dim=-1, keepdim=True))
    x_q = torch.clamp(torch.round(x / scale), -127, 127)
    return x_q.to(torch.int8), scale.to(torch.float32)


def smooth_factors(act_amax: torch.Tensor, w_amax: torch.Tensor,
                   alpha: float = 0.5) -> torch.Tensor:
    """SmoothQuant migration strength (Eq. 4 of [15])."""
    s = (torch.clamp_min(act_amax, 1e-5) ** alpha
         / torch.clamp_min(w_amax, 1e-5) ** (1 - alpha))
    return torch.clamp(s, 1e-2, 1e2)


def make_quantized_linear(w: torch.Tensor, act_amax: torch.Tensor | None = None,
                          alpha: float = 0.5) -> QuantizedLinear:
    """Quantize a [in, out] weight, optionally smoothing with activation stats."""
    smooth = None
    if act_amax is not None:
        w_amax = w.abs().amax(dim=1)
        smooth = smooth_factors(act_amax, w_amax, alpha)
        w = w * smooth[:, None]
    w_q, w_scale = quantize_weight(w, axis=0)
    return QuantizedLinear(w_q=w_q, w_scale=w_scale, smooth=smooth)


# ---------------------------------------------------------------------------
# QLC nibble packing (two 4-bit cells per 8-bit weight)
# ---------------------------------------------------------------------------
def pack_qlc(w_q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split int8 weights into (hi, lo) QLC nibble planes: hi is the signed
    high nibble in [-8, 7], lo the unsigned low nibble in [0, 15], and
    ``w == hi * 16 + lo`` exactly."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"pack_qlc takes int8 weights, got {w_q.dtype}")
    w32 = w_q.to(torch.int32)
    hi = w32 >> 4                       # arithmetic shift keeps the sign
    lo = w32 & 15
    return hi.to(torch.int8), lo.to(torch.int8)


def unpack_qlc(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int32) * 16 + lo.to(torch.int32)).to(torch.int8)


def input_bitplanes(x_q: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Decompose int8 activations into ``bits`` 0/1 planes (bit-serial
    input).  Two's complement: plane ``bits-1`` carries weight
    ``-2**(bits-1)``.  Returns int32 [bits, ...x.shape]."""
    xu = x_q.to(torch.int32) & 0xFF     # two's-complement byte
    return torch.stack([(xu >> b) & 1 for b in range(bits)])


def bit_weights(bits: int = 8, device: str | torch.device = "cpu"
                ) -> torch.Tensor:
    w = torch.tensor([1 << b for b in range(bits)], dtype=torch.int32,
                     device=device)
    w[bits - 1] = -(1 << (bits - 1))    # sign bit
    return w


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (the "SLC region", Sec. IV-A)
# ---------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8; x: [..., heads, head_dim]."""
    scale = _scale(x.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b`` for small-integer operands, on any device.

    CUDA has no integer matmul in PyTorch, so the product runs in float64:
    every partial sum of int8 x int8 (or int8 x 0/1) products over K < 2**38
    is an integer below 2**53, hence exact, and the cast back is lossless.
    ``b`` [K, N] goes in blocks of columns of at most ``EXACT_BLOCK``
    elements, so its f64 copy stays under 1 GiB at any width (an exact sum
    is the same in any order: the blocks change no bit)."""
    K, N = b.shape
    step = max(1, EXACT_BLOCK // max(K, 1))
    a64 = a.to(torch.float64)
    parts = [torch.matmul(a64, b[:, lo:lo + step].to(torch.float64)).to(torch.int32)
             for lo in range(0, N, step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def int8_matmul_ref(x_q: torch.Tensor, x_scale: torch.Tensor,
                    lin: QuantizedLinear, out_dtype=torch.float32) -> torch.Tensor:
    """Reference W8A8 matmul: int32 accumulate, f32 dequant epilogue
    ``(acc * x_s) * w_s``."""
    acc = exact_int_matmul(x_q, lin.w_q)
    return (acc.to(torch.float32) * x_scale * lin.w_scale).to(out_dtype)
