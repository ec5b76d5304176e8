"""Multi-device execution, in one process or across several
(``mesh.initialize_distributed``): (dp, sp) device meshes, the blocked
codec's frame (dp) and block (sp) sharding with no collectives,
and the BFV2 cores' sharding with an OR-reduce and an exclusive scan of
per-shard counts gathered on the mesh's home device."""
