"""repro_torch.models — the LM side of the port (``repro.models``),
dense half: configs, layers, the decoder stack and the weight converter.
MoE, MLA, MTP and the Mamba2 SSD raise ``NotImplementedError``."""
from repro_torch.models import config, layers, moe, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            forward_train,
                                            init_decode_caches, init_params,
                                            prefill)

__all__ = ["ModelConfig", "Transformer", "config", "decode_step",
           "forward_train", "init_decode_caches", "init_params", "layers",
           "moe", "prefill", "ssm", "transformer"]
