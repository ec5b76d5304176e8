"""Host-side utilities: container I/O, YUV frames, native library, synthetic clips."""
