"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].
Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
Frontend STUB: input_specs provides precomputed patch embeddings
(B, num_patches, d) prepended to the text sequence."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92553,
    frontend="vlm_stub", num_patches=256, rope_theta=1000000.0,
)
