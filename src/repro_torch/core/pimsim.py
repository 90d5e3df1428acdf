"""End-to-end single-batch token-generation model (Sec. IV-V, Fig. 5/14).

Pipelines one decoder step through the flash device:

  * sMVM stages (QKV, O, FC1, FC2, LM head) on the QLC region, each costed by
    the best hierarchical tiling found by :mod:`repro_torch.core.tiling`.
  * dMVM stages (QK^T, SV) on the SLC region: page-buffer reads overlapped
    with RPU stream-mode MACs, one or two heads per die (Sec. IV-B).
  * Controller ops (LayerNorm, softmax) on the 4 ARM cores in FP16.
  * KV append writes to SLC overlap the next layer's compute; only the
    non-hidden excess is charged.

GPU baselines (4x RTX4090 w/ vLLM, 4x A100 w/ AttAcc) are bandwidth-bound
models with calibrated efficiency factors (the paper reports only relative
numbers for these setups; see EXPERIMENTS.md for the calibration).
"""
from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core import tiling
from repro_torch.core.pim import latency as lmod
from repro_torch.core.pim import params as P
from repro_torch.core.pim.params import PlaneConfig, SIZE_A, CONVENTIONAL


# ---------------------------------------------------------------------------
# model zoo for the paper's evaluation (OPT family, [2])
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OPTConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    vocab: int = 50272
    ffn_mult: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        d = self.d_model
        per_block = 4 * d * d + 2 * self.ffn_mult * d * d
        return self.n_layers * per_block + d * self.vocab

    def kv_bytes_per_token(self, bytes_per_elem: int = 1) -> int:
        return self.n_layers * 2 * self.d_model * bytes_per_elem


OPT_MODELS = {
    "opt-6.7b": OPTConfig("opt-6.7b", 32, 4096, 32),
    "opt-13b": OPTConfig("opt-13b", 40, 5120, 40),
    "opt-30b": OPTConfig("opt-30b", 48, 7168, 56),
    "opt-66b": OPTConfig("opt-66b", 64, 9216, 72),
    "opt-175b": OPTConfig("opt-175b", 96, 12288, 96),
}

# ---------------------------------------------------------------------------
# controller (SSD ARM cores) constants
# ---------------------------------------------------------------------------
ARM_TOTAL_FLOPS = P.ARM_CORES * 2e9    # FP16 NEON, 4x Cortex-A9
LN_FLOPS_PER_ELEM = 8.0
SOFTMAX_FLOPS_PER_ELEM = 12.0

# GPU baseline specs
GPU_SPECS = {
    "rtx4090": dict(hbm_bps=1008e9, vram_gib=24.0, n=4),
    "a100": dict(hbm_bps=2039e9, vram_gib=80.0, n=4),
}
# Calibrated GPU-baseline constants (see EXPERIMENTS.md SecPaper-claims): the
# paper reports only *relative* GPU numbers (2.4x vs 4x4090; flash within 4.9%
# of 4xA100+AttAcc), so effective bandwidth + per-layer TP-collective latency
# are fit once against those claims.  RTX4090s have no NVLink -> PCIe
# all-reduce latency dominates small models; AttAcc is PIM-augmented HBM ->
# near-peak effective bandwidth.
EFF_RTX4090_VLLM = 0.52
COMM_S_PER_LAYER_RTX4090 = 110e-6
EFF_A100_ATTACC = 0.87
COMM_S_PER_LAYER_A100 = 50e-6
PREFILL_EFF = 0.25
GPU_FIT_FRACTION = 0.60                # vLLM W8A8 fits iff weights < 60% of VRAM
SLC_DIES_TOTAL = P.N_CHANNELS * P.N_WAYS * P.N_SLC_DIES
QLC_DIES_TOTAL = P.N_CHANNELS * P.N_WAYS * P.N_QLC_DIES
RPUS_ACTIVE_PER_DIE = P.PLANES_PER_DIE // 2


@dataclasses.dataclass(frozen=True)
class TpotBreakdown:
    smvm: float
    dmvm: float
    softmax: float
    ln: float
    kv_write_excess: float

    @property
    def total(self) -> float:
        return self.smvm + self.dmvm + self.softmax + self.ln + self.kv_write_excess


def _smvm_stages(m: OPTConfig) -> list[tuple[str, int, int, int]]:
    """(name, M, N, occurrences-per-token) of every static MVM."""
    d = m.d_model
    return [
        ("qkv", d, 3 * d, m.n_layers),
        ("o", d, d, m.n_layers),
        ("fc1", d, m.ffn_mult * d, m.n_layers),
        ("fc2", m.ffn_mult * d, d, m.n_layers),
        ("lm_head", d, m.vocab, 1),
    ]


@functools.lru_cache(maxsize=None)
def _best_tiling_total(m: int, n: int, plane_key: tuple, htree: bool) -> float:
    cfg = PlaneConfig(*plane_key)
    return tiling.search(m, n, plane_cfg=cfg, htree=htree, top_k=1)[0].total


def smvm_time(model: OPTConfig, plane: PlaneConfig = SIZE_A,
              htree: bool = True) -> float:
    key = (plane.n_row, plane.n_col, plane.n_stack, plane.b_cell)
    return sum(occ * _best_tiling_total(m, n, key, htree)
               for _, m, n, occ in _smvm_stages(model))


def dmvm_time(model: OPTConfig, context_len: int,
              plane: PlaneConfig = SIZE_A) -> float:
    """QK^T + SV against the SLC-resident KV cache (Sec. IV-B, Fig. 13)."""
    slc_plane = PlaneConfig(plane.n_row, plane.n_col, plane.n_stack, b_cell=P.SLC_BITS)
    t_page = lmod.t_read(slc_plane)
    per_layer_macs = 2 * context_len * model.d_model            # QK^T + SV
    # head-level parallelism: heads spread over SLC dies (1-2 heads/die)
    dies = min(SLC_DIES_TOTAL, model.n_heads)
    macs_per_die = per_layer_macs / model.n_heads * math.ceil(model.n_heads / dies)
    t_mac = macs_per_die / (RPUS_ACTIVE_PER_DIE * P.RPU_MACS_PER_CYCLE * P.RPU_CLOCK_HZ)
    kv_bytes = 2 * context_len * model.d_model                  # K and V, INT8
    pages = math.ceil(kv_bytes / P.PAGE_BYTES)
    planes_avail = SLC_DIES_TOTAL * P.PLANES_PER_DIE
    t_read = math.ceil(pages / planes_avail) * t_page
    per_layer = max(t_read, t_mac) + P.CMD_OVERHEAD_S
    return model.n_layers * per_layer


def controller_times(model: OPTConfig, context_len: int) -> tuple[float, float]:
    """(softmax, layernorm) per token on the ARM cores."""
    softmax = (model.n_layers * model.n_heads * context_len *
               SOFTMAX_FLOPS_PER_ELEM / ARM_TOTAL_FLOPS)
    ln = model.n_layers * 2 * model.d_model * LN_FLOPS_PER_ELEM / ARM_TOTAL_FLOPS
    return softmax, ln


def kv_write_excess(model: OPTConfig, hidden_budget: float) -> float:
    """SLC append of the new k/v; overlapped with compute, excess charged."""
    t = model.kv_bytes_per_token() / P.SLC_WRITE_BPS
    return max(0.0, t - hidden_budget)


def flash_tpot(model: OPTConfig, context_len: int = 1024,
               plane: PlaneConfig = SIZE_A, htree: bool = True) -> TpotBreakdown:
    smvm = smvm_time(model, plane, htree)
    dmvm = dmvm_time(model, context_len, plane)
    softmax, ln = controller_times(model, context_len)
    excess = kv_write_excess(model, hidden_budget=smvm + dmvm)
    return TpotBreakdown(smvm=smvm, dmvm=dmvm, softmax=softmax, ln=ln,
                         kv_write_excess=excess)


def naive_tpot(model: OPTConfig, plane: PlaneConfig = CONVENTIONAL,
               context_len: int = 1024) -> float:
    """Fig. 5 'conventional' baseline: conventional plane geometry driven
    through the conventional flash command protocol — one outstanding array
    operation at a time (Fig. 7a: "only one plane is accessed at a time"),
    so every unit-tile op serialises at the conventional-plane PIM latency.
    """
    t_op = lmod.t_pim(plane)
    ops = 0
    for _, m, n, occ in _smvm_stages(model):
        ops += occ * math.ceil(m / plane.tile_rows) * math.ceil(n / plane.tile_cols)
    smvm = ops * t_op
    softmax, ln = controller_times(model, context_len)
    return smvm + dmvm_time(model, context_len) + softmax + ln


# ---------------------------------------------------------------------------
# GPU baselines
# ---------------------------------------------------------------------------
def gpu_fits(model: OPTConfig, gpu: str) -> bool:
    spec = GPU_SPECS[gpu]
    vram = spec["n"] * spec["vram_gib"] * 2**30
    return model.n_params * 1 <= GPU_FIT_FRACTION * vram  # W8A8 weights


def gpu_tpot(model: OPTConfig, gpu: str, context_len: int = 1024) -> float:
    """Bandwidth-bound decode + per-layer tensor-parallel collective latency."""
    spec = GPU_SPECS[gpu]
    if gpu == "rtx4090":
        eff, comm = EFF_RTX4090_VLLM, COMM_S_PER_LAYER_RTX4090
    else:
        eff, comm = EFF_A100_ATTACC, COMM_S_PER_LAYER_A100
    bw = spec["n"] * spec["hbm_bps"] * eff
    weight_bytes = model.n_params                                  # INT8
    kv_bytes = model.kv_bytes_per_token() * context_len            # INT8 KV
    return (weight_bytes + kv_bytes) / bw + model.n_layers * comm


def gpu_prefill(model: OPTConfig, gpu: str, prompt_len: int = 1024) -> float:
    """Compute-bound summarization stage (Fig. 1b)."""
    spec = GPU_SPECS[gpu]
    peak = 165e12 if gpu == "rtx4090" else 312e12                  # bf16 peak
    flops = 2 * model.n_params * prompt_len
    return flops / (spec["n"] * peak * PREFILL_EFF)


# ---------------------------------------------------------------------------
# KV offload / endurance analyses (Sec. IV-B)
# ---------------------------------------------------------------------------
def initial_kv_write_s(model: OPTConfig, prompt_len: int = 1024) -> float:
    return model.kv_bytes_per_token() * prompt_len / P.SLC_WRITE_BPS


def offload_breakeven_tokens(model: OPTConfig, context_len: int = 1024) -> float:
    """Tokens after which the PCIe KV transfer is amortised (paper: ~12)."""
    gap = gpu_tpot(model, "rtx4090", context_len) - flash_tpot(model, context_len).total
    return initial_kv_write_s(model, context_len) / max(gap, 1e-12)


def slc_lifetime_years(model: OPTConfig, slc_gib: float = 32.0,
                       context_len: int = 1024) -> float:
    """Write-endurance lifetime of the SLC KV region with 3-day retention
    relaxation ([17]): P/E budget / (full-region overwrite rate)."""
    tpot = flash_tpot(model, context_len).total
    bytes_per_s = model.kv_bytes_per_token() / tpot
    seconds_per_pe = slc_gib * 2**30 / bytes_per_s
    cycles = P.PE_CYCLES_SLC * P.RETENTION_RELAX_FACTOR
    return cycles * seconds_per_pe / (365.25 * 24 * 3600)
