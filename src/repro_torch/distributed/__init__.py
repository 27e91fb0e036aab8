"""repro_torch.distributed — the tablet mesh's pieces: ``sharding.
mesh_axis_size`` (the port of ``repro.distributed.sharding``'s one
suffix-array helper) and ``collectives`` (``psum``, ``all_gather``,
``all_to_all``, ``ppermute`` over per-tablet tensors)."""
