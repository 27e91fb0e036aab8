"""repro_torch.models — the LM side of the port (``repro.models``):
configs, layers (GQA, MLA, MLPs), MoE, the Mamba2 SSD, the decoder stack
(prefix + periods, MTP) and the weight converter."""
from repro_torch.models import config, layers, moe, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            forward_train,
                                            init_decode_caches, init_params,
                                            prefill)

__all__ = ["ModelConfig", "Transformer", "config", "decode_step",
           "forward_train", "init_decode_caches", "init_params", "layers",
           "moe", "prefill", "ssm", "transformer"]
