"""Model / shape configuration system.

One :class:`ModelConfig` dataclass covers every assigned architecture family
(dense / MoE / SSM / hybrid / enc-dec / VLM).  Every config can produce a
``reduced()`` sibling — same family and wiring, tiny dimensions — used by the
CPU smoke tests; the full configs are exercised only through the dry-run
(ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"             # gqa | mla | none
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False
    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MLP
    mlp_type: str = "swiglu"           # swiglu | gelu | relu2

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1                 # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    first_dense_layers: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0                # hybrid: layer i is attention iff i % attn_every == attn_offset
    attn_offset: int = 0

    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0

    # modality frontend
    input_mode: str = "tokens"         # tokens | embeddings (stubbed frontend)

    norm_type: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    mtp: bool = False                  # DeepSeek multi-token-prediction head
    notes: str = ""

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every) == self.attn_offset else "ssm"
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense_layers:
            return False
        return (i % self.moe_every) == self.moe_offset

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM and hybrid archs only (DESIGN.md Sec. 4)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch has a decode path (whisper is enc-dec)

    # ---- parameter counting (analytical; verified against init in tests) --
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = v * d                                   # embed
        if not self.tie_embeddings:
            total += d * v                              # lm head
        for i in range(self.n_layers):
            total += self._layer_params(i)
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                total += self._attn_params() + d * self.d_ff * 2 + 4 * d
            total += self.encoder_seq * 0               # sinusoidal pos: no params
            total += self.n_layers * self._attn_params()  # cross-attention
        if self.mtp:
            total += self._layer_params(self.n_layers - 1) + 2 * d * d
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_type == "mla":
            qk_head = self.qk_nope_head_dim + self.qk_rope_head_dim
            q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk_head
            kv = d * (self.kv_lora_rank + self.qk_rope_head_dim)
            kv += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            o = self.n_heads * self.v_head_dim * d
            return q + kv + o
        hd = self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _mlp_params(self, ff: int) -> int:
        per = 3 if self.mlp_type == "swiglu" else 2
        return per * self.d_model * ff

    def _ssm_params(self) -> int:
        di, st = self.d_inner, self.ssm_state
        in_proj = self.d_model * (2 * di + 2 * self.ssm_groups * st + self.ssm_heads)
        conv = (di + 2 * self.ssm_groups * st) * self.ssm_conv
        return in_proj + conv + 2 * self.ssm_heads + di + di * self.d_model

    def _layer_params(self, i: int) -> int:
        kind = self.layer_kind(i)
        p = 2 * self.d_model                            # norms
        p += self._ssm_params() if kind == "ssm" else self._attn_params()
        if self.is_moe_layer(i):
            p += self.d_model * self.n_experts          # router
            p += self.n_experts * self._mlp_params(self.moe_d_ff)
            p += self.n_shared_experts * self._mlp_params(self.moe_d_ff)
        elif kind == "attn" or self.family == "hybrid":
            ff = self.d_ff if self.d_ff else 0
            if ff:
                p += self._mlp_params(ff)
        return p

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed-active experts)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        for i in range(self.n_layers):
            if self.is_moe_layer(i):
                inactive = self.n_experts - self.n_experts_active
                total -= inactive * self._mlp_params(self.moe_d_ff)
        return total

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = dict(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 8),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_experts_active=min(self.n_experts_active, 2) if self.n_experts else 0,
            moe_d_ff=128 if self.n_experts else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=min(self.attn_every, 4) if self.attn_every else 0,
            attn_offset=min(self.attn_offset, 1) if self.attn_every else 0,
        )
        return dataclasses.replace(self, name=self.name + "-smoke", **scale)
