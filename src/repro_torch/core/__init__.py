"""repro_torch.core — codec, suffix-array build, tablet store, query and
the scan planner, ported from ``repro.core`` (single device)."""
