"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; attention at layer i%8==4; MoE on every 2nd layer."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_d_ff=14336, moe_every=2,
    attn_every=8, attn_offset=4,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    rope_theta=10000.0,
)
