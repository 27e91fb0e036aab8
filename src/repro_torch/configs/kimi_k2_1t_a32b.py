"""kimi-k2-1t-a32b [moe] — trillion-param MoE [arXiv:2501.kimi2].
Pool spec: 61L d_model=7168 64H (GQA kv=8... pool annotation; the released
K2 uses MLA — we follow the pool table's MLA-style low-rank attention with
64 heads) d_ff(expert)=2048 vocab=163840, MoE 384e top-8, 1 shared."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,               # 7168 / 64
    d_ff=18432,
    vocab_size=163840,
    attn_type="gqa",            # pool table: GQA kv=8
    num_experts=384,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_dense_layers=1,
    rope_theta=50000.0,
)
