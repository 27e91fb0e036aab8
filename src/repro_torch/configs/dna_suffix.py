"""The paper's own workload config: tablet-sharded suffix array over a
human-chromosome-scale DNA string, serving random-pattern scans
(Giacomelli 2020 §IV-V)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SuffixArrayConfig:
    name: str = "dna-suffix"
    text_len: int = 250_000_000      # ~chromosome 1 (bases)
    max_query_len: int = 112         # paper workload <= 100, word-aligned
    query_batch: int = 1024          # concurrent scans per step
    tablets_per_device: int = 1
    sort_method: str = "bitonic"     # construction sort (or "sample")


CONFIG = SuffixArrayConfig()
