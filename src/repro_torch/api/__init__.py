"""repro_torch.api — the in-memory ``SuffixTable`` (read and write path,
frozen FM tier) ported from ``repro.api``."""
from repro_torch.api.fm import FMIndex
from repro_torch.api.table import SuffixTable

__all__ = ["FMIndex", "SuffixTable"]
