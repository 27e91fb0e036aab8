"""repro_torch.api — ``SuffixTable`` (read and write path, compaction,
durable tables under a ``Catalog`` root, the frozen FM tier) ported from
``repro.api``."""
from repro_torch.api.catalog import Catalog
from repro_torch.api.fm import FMIndex
from repro_torch.api.table import SuffixTable

__all__ = ["Catalog", "FMIndex", "SuffixTable"]
