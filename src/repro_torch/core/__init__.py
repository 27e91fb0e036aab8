"""repro_torch.core — codec, suffix-array build (single device and over
a tablet mesh), tablet store, query and the scan planner, ported from
``repro.core``."""
