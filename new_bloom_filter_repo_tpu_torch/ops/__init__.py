"""Device ops: per-geometry hash tables and the blocked Bloom kernels (K1-K5b)."""
