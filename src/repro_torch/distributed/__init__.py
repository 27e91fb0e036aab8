"""repro_torch.distributed — the meshes' pieces, single controller:
``collectives`` (``psum``, ``all_gather``, ``all_to_all``, ``ppermute``,
``axis_index`` over per-shard tensors, optionally within a named axis),
``sharding`` (the LM sharding rules and ``mesh_axis_size``),
``compression`` (int8 gradient exchange with error feedback) and
``pipeline`` (GPipe over a mesh axis)."""
