"""repro_torch.api — the in-memory ``SuffixTable`` (read and write path)
ported from ``repro.api``."""
from repro_torch.api.table import SuffixTable

__all__ = ["SuffixTable"]
