"""B6: the Mamba2 SSD intra-chunk step (``csrc/ssd_chunk.cu``), its plain
version, and the chunked SSD forward built on it.

Replaces ``repro/kernels/ssm_scan/kernel.py::ssd_chunk_pallas`` (oracle
``ref.py::ref_chunk``, wrapper ``ops.py::ssd_forward``).  B and C come per
group ([N, Q, G, S]; head h reads group ``h // (H // G)``; G = H is the
per-head layout of the reference).  One launch holds two kinds of block: a
y block computes the group's scores C.B^T for 32 query rows once and
applies them to up to four heads, each with its own decay; a state block
computes 64 columns of one head's chunk state.  All four products run as
3xTF32 on the tensor cores (hi/lo split, three ``mma.sync`` per tile), near
f32 accuracy; TF32 alone cannot hold the reference's tolerance.  Bound: f32
operations.  The within-chunk cumsum runs in f64 in both versions, so the
kernel and the plain version share it (and the decay) bit for bit; against
the plain version y and the state agree within ``rtol=2e-4, atol=2e-5``
(the reference's own tolerance), the decay within ``rtol=1e-5``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels as KN
from repro_torch.kernels import _build

launches = 0


def chunk_cumsum(la: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum of f32 ``la`` along ``dim``, summed in f64 and rounded
    to f32 once per step, as the kernel sums it."""
    return torch.cumsum(la.to(torch.float64), dim).to(torch.float32)


def group_to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., G, S] -> [..., H, S]: head h takes group ``h // (H // G)``."""
    groups = t.shape[-2]
    if heads % groups:
        raise ValueError(f"{heads} heads do not split into {groups} groups")
    return torch.repeat_interleave(t, heads // groups, dim=-2) if heads > groups else t


def ssd_chunk_plain(x, B, C, dt, A, D, h_in):
    """x [N,Q,H,dh]; B, C [N,Q,G,S] (G divides H); dt [N,Q,H]; A, D [H];
    h_in [N,H,dh,S], all f32 -> (y [N,Q,H,dh], S_out [N,H,dh,S], decay
    [N,H]): the reference's ``ref_chunk`` over B and C expanded to heads,
    batched over N."""
    Q, H = x.shape[1], x.shape[2]
    B, C = group_to_heads(B, H), group_to_heads(C, H)
    la = dt * A[None, None, :]                                   # [N,Q,H]
    cs = chunk_cumsum(la, 1)
    xdt = x * dt[..., None]
    Ldec = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])      # [N,Q,K,H]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Ldec = torch.where(tril[None, :, :, None], Ldec, torch.zeros((), device=x.device))
    scores = torch.einsum("nqhs,nkhs->nqkh", C, B) * Ldec
    y = torch.einsum("nqkh,nkhd->nqhd", scores, xdt)
    y = y + torch.einsum("nqhs,nhds->nqhd", C * torch.exp(cs)[..., None], h_in)
    y = y + D[None, None, :, None] * x
    decay_end = torch.exp(cs[:, -1:, :] - cs)                    # [N,Q,H]
    S_out = torch.einsum("nkhs,nkhd->nhds", B * decay_end[..., None], xdt)
    return y, S_out, torch.exp(cs[:, -1, :])


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(Q: int, H: int, G: int, dh: int, S: int) -> int:
    """The dynamic shared memory one B6 block takes at these dimensions."""
    fn = _lib().ssd_chunk_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    return int(fn(Q, H, G, dh, S))


def ssd_chunk_cuda(x, B, C, dt, A, D, h_in):
    """Launch B6 on CUDA tensors; same contract as :func:`ssd_chunk_plain`.
    The kernel takes Q up to 128 and dh up to 64 (mamba2's chunk and head
    width); the launch refuses (and this raises) anything else, or operands
    that overflow one block's shared memory."""
    global launches
    N, Q, H, dh = x.shape
    G, S = B.shape[-2:]
    f32 = torch.float32
    if H % G:
        raise ValueError(f"ssd_chunk: {H} heads do not split into {G} groups")
    KN.require(x, "x", f32, (N, Q, H, dh))
    KN.require(B, "B", f32, (N, Q, G, S))
    KN.require(C, "C", f32, (N, Q, G, S))
    KN.require(dt, "dt", f32, (N, Q, H))
    KN.require(A, "A", f32, (H,))
    KN.require(D, "D", f32, (H,))
    KN.require(h_in, "h_in", f32, (N, H, dh, S))
    y = torch.empty_like(x)
    s_out = torch.empty_like(h_in)
    decay = torch.empty((N, H), dtype=f32, device=x.device)
    err = _lib().ssd_chunk_launch(
        KN.ptr(x), KN.ptr(B), KN.ptr(C), KN.ptr(dt), KN.ptr(A), KN.ptr(D),
        KN.ptr(h_in), KN.ptr(y), KN.ptr(s_out), KN.ptr(decay), N, Q, H, G, dh, S,
        KN.stream(x))
    KN.check(err, f"ssd_chunk at N={N} Q={Q} H={H} G={G} dh={dh} S={S}")
    launches += 1
    return y, s_out, decay


def ssd_chunk(x, B, C, dt, A, D, h_in):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x, B, C, dt, A, D, h_in):
        return ssd_chunk_cuda(x, B, C, dt, A, D, h_in)
    return ssd_chunk_plain(x, B, C, dt, A, D, h_in)


def ssd_forward(x, B, C, dt, A, D, *, chunk: int = 128, h0=None):
    """x [Bt,T,H,dh]; B, C [Bt,T,G,S] (G divides H); dt [Bt,T,H]; A, D [H] ->
    (y [Bt,T,H,dh], h_last [Bt,H,dh,S]).  T pads with zeros to ``nc * Q``
    (``Q = min(chunk, T)``); one B6 launch per chunk over the whole batch,
    and the inter-chunk recurrence ``h = decay * h + S_out`` in torch, as
    the reference's ``ops.ssd_forward`` scans it."""
    Bt, T, H, dh = x.shape
    G, S = B.shape[-2:]
    Q = min(chunk, T)
    nc = math.ceil(T / Q)
    pad = nc * Q - T
    if pad:
        x, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    xc = x.reshape(Bt, nc, Q, H, dh)
    Bc = B.reshape(Bt, nc, Q, G, S)
    Cc = C.reshape(Bt, nc, Q, G, S)
    dtc = dt.reshape(Bt, nc, Q, H)
    h = (h0 if h0 is not None
         else torch.zeros((Bt, H, dh, S), dtype=torch.float32, device=x.device))
    ys = []
    for c in range(nc):
        y, s_out, dec = ssd_chunk(xc[:, c].contiguous(), Bc[:, c].contiguous(),
                                  Cc[:, c].contiguous(), dtc[:, c].contiguous(),
                                  A.contiguous(), D.contiguous(), h.contiguous())
        h = dec[:, :, None, None] * h + s_out
        ys.append(y)
    y = torch.stack(ys, 1).reshape(Bt, nc * Q, H, dh)[:, :T]
    return y, h
