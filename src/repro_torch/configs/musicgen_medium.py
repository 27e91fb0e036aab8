"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048.  Frontend STUB: input_specs provides precomputed frame
embeddings (B, S, d); the EnCodec encoder itself is out of scope."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
    num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=2048,
    mlp_act="gelu", frontend="audio_stub", rope_theta=10000.0,
)
