"""Multi-device execution of the blocked codec: (dp, sp) device meshes,
frame (dp) and block (sp) sharding with no collectives, in one process."""
