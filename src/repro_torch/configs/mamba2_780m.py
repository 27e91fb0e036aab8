"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060].
48L d_model=1536 attn-free, d_ff=0, vocab=50280, ssm_state=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    attn_type="none", ssm_state=128, ssm_headdim=64, ssm_expand=2,
    ssm_conv=4, ssm_chunk=256, tie_embeddings=True,
)
