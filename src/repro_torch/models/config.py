"""Architecture config schema for every assigned model family — a copy
of ``repro.models.config`` (jax-free there too).

One frozen dataclass covers dense/GQA, MLA, MoE, SSM (Mamba2 SSD), hybrid
(Jamba), audio-backbone and VLM-backbone variants.  ``reduced()`` derives
the CPU smoke-test config of the same family (same code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention flavour
    attn_type: str = "gqa"           # gqa | mla | none
    rope_theta: float = 10000.0
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5
    mlp_act: str = "swiglu"          # swiglu | gelu

    # MLA (deepseek-v3 / kimi-k2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek: first 3 layers dense
    moe_every: int = 1               # jamba: MoE every 2nd layer
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # hybrid / SSM
    attn_every: int = 0              # jamba: 1 attention layer per 8
    attn_offset: int = 4             # which slot in the period is attention
    ssm_state: int = 0               # mamba2 N
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3

    # modality frontend (STUB per spec: precomputed embeddings)
    frontend: str = "none"           # none | audio_stub | vlm_stub
    num_patches: int = 0             # vlm: vision tokens prepended

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_query_len: int = 0           # unused by LMs; SA engine configs only

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.attn_type == "mla":
            if self.v_head_dim == 0:
                object.__setattr__(self, "v_head_dim", self.head_dim)

    # ---- derived -----------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.attn_type == "none"

    @property
    def is_hybrid(self) -> bool:
        return self.attn_every > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for the mixer of layer i."""
        if self.is_ssm_only:
            return "ssm"
        if self.is_hybrid:
            return "attn" if i % self.attn_every == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.is_moe:
            return False
        if i < self.first_dense_layers:
            return False
        return i % self.moe_every == (self.moe_every - 1)

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (scan unit)."""
        import math
        p = 1
        if self.is_hybrid:
            p = self.attn_every
        if self.is_moe and self.moe_every > 1:
            p = p * self.moe_every // math.gcd(p, self.moe_every)
        return p

    def param_count(self) -> int:
        """Approximate total parameter count (used for 6ND roofline)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        total = V * d * (1 if self.tie_embeddings else 2)
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attn_type == "mla":
                    qh = self.head_dim + self.rope_head_dim
                    q = (d * self.q_lora_rank
                         + self.q_lora_rank * self.num_heads * qh
                         ) if self.q_lora_rank else d * self.num_heads * qh
                    kv = (d * (self.kv_lora_rank + self.rope_head_dim)
                          + self.kv_lora_rank * self.num_heads
                          * (self.head_dim + self.v_head_dim))
                    o = self.num_heads * self.v_head_dim * d
                    total += q + kv + o
                else:
                    total += d * self.num_heads * self.head_dim  # q
                    total += 2 * d * self.num_kv_heads * self.head_dim
                    total += self.num_heads * self.head_dim * d  # o
            else:
                di, N = self.d_inner, self.ssm_state
                total += d * (2 * di + 2 * N + self.ssm_heads)  # in_proj
                total += di * d                                  # out_proj
                total += (di + 2 * N) * self.ssm_conv            # conv
            # FFN: MoE, dense, or absent (pure-SSM blocks have none)
            n_mults = 3 if self.mlp_act == "swiglu" else 2
            if self.layer_is_moe(i):
                total += (self.num_experts + self.num_shared_experts) \
                    * n_mults * d * self.moe_d_ff
                total += d * self.num_experts                    # router
            elif f > 0:
                total += n_mults * d * f
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed-in experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        n_mults = 3 if self.mlp_act == "swiglu" else 2
        per_expert = n_mults * self.d_model * self.moe_d_ff
        n_moe_layers = sum(self.layer_is_moe(i)
                           for i in range(self.num_layers))
        inactive = n_moe_layers * per_expert * \
            (self.num_experts - self.experts_per_token)
        return full - inactive

    # ---- smoke-test reduction -----------------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family/code paths, laptop-sized."""
        changes = dict(
            num_layers=min(self.num_layers, self.period * 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_patches=min(self.num_patches, 8),
        )
        if self.attn_type == "mla":
            changes.update(q_lora_rank=64 if self.q_lora_rank else 0,
                           kv_lora_rank=32, rope_head_dim=16, v_head_dim=32)
        if self.is_moe:
            changes.update(num_experts=8, experts_per_token=2, moe_d_ff=64,
                           first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.mtp_depth:
            changes.update(mtp_depth=1)
        return dataclasses.replace(self, **changes)
