"""repro_torch.data — the synthetic LM data pipeline and its dedup hook,
ported from ``repro.data``."""
from repro_torch.data.pipeline import (DataConfig, dna_corpus,
                                       make_batch_iter, synthetic_batch)

__all__ = ["DataConfig", "dna_corpus", "make_batch_iter", "synthetic_batch"]
