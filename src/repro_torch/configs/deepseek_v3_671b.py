"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].  61L d_model=7168 128H d_ff(expert)=2048
vocab=129280; first 3 layers dense (d_ff 18432 folded into prefix MoE-free
layers via d_ff), q LoRA 1536 / kv LoRA 512, nope 128 + rope 64, v 128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                 # dense layers (first 3)
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    mtp_depth=1,
    rope_theta=10000.0,
)
