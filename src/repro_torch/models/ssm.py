"""Mamba2 SSD (state-space duality) block -- arXiv:2405.21060.

PyTorch counterpart of ``repro.models.ssm``.  Prefill uses the chunked SSD
algorithm (intra-chunk quadratic part + inter-chunk recurrent state);
``use_kernel=True`` runs the intra-chunk part through B6
(``kernels/ssd_chunk.py``), the other path is the reference's pure-tensor
chunked form.  Decode is the O(1) recurrence in plain torch (the reference
has no kernel for it).  The constant-size recurrent state is the SSM analog
of the paper's SLC region: small, rewritten every token, never growing with
context.

Projections are stored split (w_z, w_x, w_B, w_C, w_dt), as in the
reference; under W8A8 only w_z, w_x and out_proj are quantized.

On a mesh a layer runs a rank's block of heads (:class:`HeadBlock`):
``w_z`` and ``w_x`` come column-parallel in contiguous head blocks, the
rank takes its heads' entries of the per-head rates (``w_dt``'s output,
its softplus and the decay ``exp(dt * A)``, computed over every head from
the replicated leaves and then cut: on the CPU an elementwise function of
fewer or strided entries may take another vector path, and a float
product with fewer columns may sum in another order), its channels of
``conv_x`` and entries of ``D`` out of the replicated leaves,
and ``w_B``, ``w_C`` and their convs stay whole (a head reads its group by
its global index, as the reference's ``_group_to_heads`` maps it).
``y * silu(z)`` is all-gathered over the model axis before the gated
RMSNorm, which so sees one device's whole ``d_inner`` row, and
``out_proj`` runs row-parallel on the rank's block of the normed row.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as C
from repro_torch.kernels import ssd_chunk as ssd_ops
from repro_torch.models import layers as L

Params = dict[str, Any]
# the quantized linears that read a block's input: ``x_q`` of the functions
# below is that input's int8 pair (``layers.apply_norm_q``)
INPUT_LINEARS = ("w_z", "w_x")


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    """Random parameters drawn from ``gen`` (on its device); the same leaves
    and shapes as the reference's ``ssm_init``."""
    d, di = cfg.d_model, cfg.d_inner
    G, S, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    p = {"w_z": L.dense_init(gen, d, di, dtype)["w"],
         "w_x": L.dense_init(gen, d, di, dtype)["w"],
         "w_B": L.dense_init(gen, d, G * S, dtype)["w"],
         "w_C": L.dense_init(gen, d, G * S, dtype)["w"],
         "w_dt": L.dense_init(gen, d, H, dtype)["w"],
         "conv_x": normal(cfg.ssm_conv, di) * 0.2,
         "conv_B": normal(cfg.ssm_conv, G * S) * 0.2,
         "conv_C": normal(cfg.ssm_conv, G * S) * 0.2,
         "conv_bx": torch.zeros((di,), dtype=dtype, device=dev),
         "conv_bB": torch.zeros((G * S,), dtype=dtype, device=dev),
         "conv_bC": torch.zeros((G * S,), dtype=dtype, device=dev),
         "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                           device=dev)),
         "D": torch.ones((H,), dtype=torch.float32, device=dev),
         "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
         "norm": L.norm_init(di, device=dev),
         "out_proj": L.dense_init(gen, di, d, dtype)["w"]}
    return p


class HeadBlock(NamedTuple):
    """A rank's block of an SSM layer on a mesh: heads ``[h0, h0 + n)``,
    the model axis' group (``launch.mesh.AxisGroup``) that gathers the
    gated rows, and ``out_proj``'s row-parallel reduction
    (``layers.RowReduce``)."""
    h0: int
    n: int
    group: Any
    reduce: Any


def group_block(cfg: ModelConfig, h0: int, n: int) -> tuple[int, int]:
    """The B/C groups ``[g0, g0 + gn)`` that heads ``[h0, h0 + n)`` read
    (head h reads group ``h // (H // G)``), so that ``group_to_heads`` of
    the block over its n heads maps each head to its own group: the block
    holds whole groups, or lies inside one."""
    per = cfg.ssm_heads // cfg.ssm_groups
    if n % per == 0:
        return h0 // per, n // per
    if per % n == 0:
        return h0 // per, 1
    raise ValueError(f"{n} heads from {h0} split a B/C group of {per} heads")


def _local(p: Params, cfg: ModelConfig, blk: HeadBlock | None) -> tuple[Params, int, tuple]:
    """The leaves a rank's heads read (``blk``: the block on a mesh, None
    off one), its head count and its groups: ``conv_x``'s channels and
    ``D`` cut to the heads (``w_z``, ``w_x`` and ``out_proj`` arrive as the
    rank's blocks; :func:`_heads` cuts the per-head rates)."""
    if blk is None:
        return p, cfg.ssm_heads, (0, cfg.ssm_groups)
    hd = cfg.ssm_head_dim
    ch = slice(blk.h0 * hd, (blk.h0 + blk.n) * hd)
    q = dict(p)
    q["conv_x"], q["conv_bx"] = p["conv_x"][:, ch], p["conv_bx"][ch]
    q["D"] = p["D"][blk.h0:blk.h0 + blk.n]
    return q, blk.n, group_block(cfg, blk.h0, blk.n)


def _softplus(t: torch.Tensor) -> torch.Tensor:
    """``softplus(t)``, on the CPU over a buffer padded to a multiple of 64
    entries: the CPU's vectorized softplus takes another path for the
    entries past its last whole block of vectors, so without the padding an
    entry's bits would depend on how many rows the call holds (a rank on a
    mesh holds its slots only)."""
    if t.is_cuda or t.device.type == "meta":
        return F.softplus(t)
    flat = t.reshape(-1)
    pad = -flat.numel() % 64
    return F.softplus(F.pad(flat, (0, pad)))[:flat.numel()].reshape(t.shape)


def _heads(t: torch.Tensor, blk: HeadBlock | None) -> torch.Tensor:
    """The rank's heads' entries (last dim) of a per-head tensor, contiguous."""
    return t if blk is None else t[..., blk.h0:blk.h0 + blk.n].contiguous()


def _groups(t: torch.Tensor, cfg: ModelConfig, gb: tuple) -> torch.Tensor:
    """The block's groups ``gb`` of B or C rows ``[..., G * S]``."""
    S = cfg.ssm_state
    return t if gb == (0, cfg.ssm_groups) else t[..., gb[0] * S:(gb[0] + gb[1]) * S]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  x: [B, T, C]; w: [K, C]."""
    K, T = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for j in range(K):
        shift = K - 1 - j
        xj = F.pad(x, (0, 0, shift, 0))[:, :T]
        out = out + xj * w[j]
    return out + b


def _projections(p: Params, cfg: ModelConfig, x: torch.Tensor, backend: str,
                 x_q: tuple | None = None):
    return tuple(L.apply_linear(L._lin(p, name), x, backend, x_q)
                 for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _gate_norm_out(p: Params, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
                   backend: str, blk: HeadBlock | None = None) -> torch.Tensor:
    """``out_proj(norm(y * silu(z)))``, the block's tail on every path; the
    norm hands ``out_proj`` its output's int8 pair
    (:func:`layers.apply_norm_q`).  On a mesh the rank's gated columns are
    all-gathered over the model axis first (a gather of float columns is
    exact, so the norm sees one device's row) and ``out_proj`` takes the
    rank's block of the normed row and of its pair, row-parallel."""
    g = y * F.silu(z.to(torch.float32)).to(y.dtype)
    if blk is not None:
        g = C.all_gather(g, blk.group, dim=-1)
    y, y_q = L.apply_norm_q(p["norm"], g, backend, p, ("out_proj",))
    if blk is None:
        return L.apply_linear(L._lin(p, "out_proj"), y.to(x.dtype), backend, y_q)
    w = y.shape[-1] // blk.group.size
    cols = slice(blk.group.index * w, (blk.group.index + 1) * w)
    y_q = None if y_q is None else (y_q[0][..., cols], y_q[1])
    return L.apply_linear(L._lin(p, "out_proj"), y[..., cols].to(x.dtype), backend, y_q,
                          reduce=blk.reduce)


def ssm_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                chunk: int = 128, backend: str = "dense",
                initial_state: torch.Tensor | None = None,
                return_state: bool = False, use_kernel: bool = False,
                x_q: tuple | None = None, blk: HeadBlock | None = None):
    """x: [B, T, d] -> [B, T, d] (chunked SSD), and with ``return_state``
    the decode state that continues the sequence; ``x_q`` x's int8 pair for
    :data:`INPUT_LINEARS`; ``blk`` the rank's heads on a mesh (its state
    holds its heads' ``h`` and ``conv_x`` channels).

    ``use_kernel=True`` routes the intra-chunk quadratic core through B6
    (:func:`repro_torch.kernels.ssd_chunk.ssd_forward`); the tensor path
    below is its oracle."""
    B, T, _ = x.shape
    p, H, gb = _local(p, cfg, blk)
    S, G, hd = cfg.ssm_state, gb[1], cfg.ssm_head_dim
    di = H * hd
    z, xs_pre, B_pre, C_pre, dt = _projections(p, cfg, x, backend, x_q)
    xs_c1 = F.silu(_causal_conv(xs_pre, p["conv_x"].to(x.dtype), p["conv_bx"].to(x.dtype)))
    B_c = _groups(F.silu(_causal_conv(B_pre, p["conv_B"].to(x.dtype),
                                      p["conv_bB"].to(x.dtype))), cfg, gb)
    C_c = _groups(F.silu(_causal_conv(C_pre, p["conv_C"].to(x.dtype),
                                      p["conv_bC"].to(x.dtype))), cfg, gb)
    xs = xs_c1.reshape(B, T, H, hd)
    Bm = B_c.reshape(B, T, G, S)
    Cm = C_c.reshape(B, T, G, S)
    dt = _heads(_softplus(dt.to(torch.float32) + p["dt_bias"]), blk)     # [B,T,H]
    A = _heads(-torch.exp(p["A_log"]), blk)                               # [H]

    def state(h_last):
        return {"conv_x": _tail(xs_pre, cfg), "conv_B": _tail(B_pre, cfg),
                "conv_C": _tail(C_pre, cfg), "h": h_last}

    if use_kernel:             # B6 takes B and C per group
        y4, h_last = ssd_ops.ssd_forward(xs.to(torch.float32), Bm.to(torch.float32),
                                         Cm.to(torch.float32), dt, A, p["D"],
                                         chunk=chunk, h0=initial_state)
        out = _gate_norm_out(p, y4.reshape(B, T, di), z, x, backend, blk)
        return (out, state(h_last)) if return_state else out

    Q = min(chunk, T)
    nc = math.ceil(T / Q)
    pad = nc * Q - T
    if pad:
        xs, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    xs_c = xs.reshape(B, nc, Q, H, hd).to(torch.float32)
    Bc = ssd_ops.group_to_heads(Bm.reshape(B, nc, Q, G, S), H).to(torch.float32)
    Cc = ssd_ops.group_to_heads(Cm.reshape(B, nc, Q, G, S), H).to(torch.float32)
    dtc = dt.reshape(B, nc, Q, H)

    la = dtc * A                                                          # [B,nc,Q,H]
    cs = ssd_ops.chunk_cumsum(la, 2)
    xdt = xs_c * dtc[..., None]
    # intra-chunk (quadratic within the chunk)
    Ldec = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])         # [B,nc,Q,K,H]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Ldec = torch.where(tril[None, None, :, :, None], Ldec,
                       torch.zeros((), device=x.device))
    scores = torch.einsum("bnqhs,bnkhs->bnqkh", Cc, Bc) * Ldec
    y_intra = torch.einsum("bnqkh,bnkhd->bnqhd", scores, xdt)
    # chunk states
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)                          # [B,nc,Q,H]
    Sn = torch.einsum("bnkhs,bnkhd->bnhds", Bc * decay_end[..., None], xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :])                              # [B,nc,H]

    h = (initial_state if initial_state is not None
         else torch.zeros((B, H, hd, S), dtype=torch.float32, device=x.device))
    h_prev = []
    for c in range(nc):                  # emit the state *before* each chunk
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + Sn[:, c]
    h_prev = torch.stack(h_prev, 1)                                       # [B,nc,H,hd,S]
    y_inter = torch.einsum("bnqhs,bnhds->bnqhd", Cc * torch.exp(cs)[..., None], h_prev)
    y = y_intra + y_inter + p["D"][None, None, None, :, None] * xs_c
    y = y.reshape(B, nc * Q, di)[:, :T]
    out = _gate_norm_out(p, y, z, x, backend, blk)
    return (out, state(h)) if return_state else out


def _tail(seq: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Last K-1 pre-conv inputs, for decode continuation after prefill."""
    K = cfg.ssm_conv
    tail = seq[:, max(0, seq.shape[1] - (K - 1)):]
    if tail.shape[1] < K - 1:
        tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
    return tail.to(torch.float32)


def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: str | torch.device = "cpu", heads: int | None = None) -> dict:
    """The zero recurrent state of ``batch`` slots; ``heads`` (a rank's
    head count on a mesh) sizes ``h`` and ``conv_x`` to the rank's heads,
    ``conv_B`` / ``conv_C`` stay whole."""
    K = cfg.ssm_conv - 1
    GS = cfg.ssm_groups * cfg.ssm_state
    H = cfg.ssm_heads if heads is None else heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"conv_x": zeros(batch, K, H * cfg.ssm_head_dim),
            "conv_B": zeros(batch, K, GS),
            "conv_C": zeros(batch, K, GS),
            "h": zeros(batch, H, cfg.ssm_head_dim, cfg.ssm_state)}


def _conv_step(buf, new, w, b):
    """One step of the depthwise conv: the window's K taps multiplied, then
    summed over the taps in one reduction, which adds each channel's K
    products in tap order whatever the channel count (a contraction
    kernel's order may follow how many channels the call holds, and a rank
    on a mesh holds its heads' channels)."""
    window = torch.cat([buf, new[:, None].to(torch.float32)], dim=1)
    out = (window * w.to(torch.float32)).sum(1)
    return F.silu(out + b), window[:, 1:]


def ssm_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, state: dict,
               backend: str = "dense", x_q: tuple | None = None,
               blk: HeadBlock | None = None) -> tuple[torch.Tensor, dict]:
    """One-step recurrence.  x: [B, 1, d] -> ([B, 1, d], new state); ``x_q``
    x's int8 pair for :data:`INPUT_LINEARS`; ``blk`` the rank's heads on a
    mesh (see :func:`ssm_forward`)."""
    B = x.shape[0]
    p, H, gb = _local(p, cfg, blk)
    S, G, hd = cfg.ssm_state, gb[1], cfg.ssm_head_dim
    di = H * hd
    z, xs_pre, B_pre, C_pre, dt = _projections(
        p, cfg, x[:, 0], backend, None if x_q is None else (x_q[0][:, 0], x_q[1][:, 0]))
    xh_c, conv_x = _conv_step(state["conv_x"], xs_pre, p["conv_x"], p["conv_bx"])
    Bm_c, conv_B = _conv_step(state["conv_B"], B_pre, p["conv_B"], p["conv_bB"])
    Cm_c, conv_C = _conv_step(state["conv_C"], C_pre, p["conv_C"], p["conv_bC"])
    xh = xh_c.reshape(B, H, hd)
    Bm = ssd_ops.group_to_heads(_groups(Bm_c, cfg, gb).reshape(B, G, S), H)
    Cm = ssd_ops.group_to_heads(_groups(Cm_c, cfg, gb).reshape(B, G, S), H)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])                   # [B,H]
    a = _heads(torch.exp(dt * -torch.exp(p["A_log"])), blk)               # [B,H]
    dt = _heads(dt, blk)
    xdt = xh * dt[..., None]
    h_new = a[:, :, None, None] * state["h"] + torch.einsum("bhd,bhs->bhds", xdt, Bm)
    y = torch.einsum("bhds,bhs->bhd", h_new, Cm) + p["D"][None, :, None] * xh
    out = _gate_norm_out(p, y.reshape(B, di), z, x, backend, blk)
    return out[:, None], {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                          "h": h_new}
