"""PyTorch/CUDA port of the rational-Bloom-filter lossless video codec.

The counterpart of :mod:`new_bloom_filter_repo_tpu` (the JAX package,
which stays the reference) for NVIDIA Hopper cards.  Module names mirror
the reference's, so each module's counterpart is easy to find.  Plain
tensor code is PyTorch; the blocked rational-Bloom kernels are
hand-written CUDA C++ (``ops/csrc/blocked.cu``), built at
first use, each with a plain PyTorch twin that CPU tensors run.

The port covers every mode and profile of the JAX package's
``ImprovedVideoCompressor`` (``mode="bloom"``/``"keyframe"``;
``profile="blocked"``/``"bfv2"``/``"planar"``; ``exact=False``; uint8,
uint16, float32 and >3-channel frames), ``FixedVideoCompressor`` and the
binary codec ``BloomFilterCompressor``, each with an explicit ``device``
argument, on one device or, with ``devices=``, on a (dp, sp) mesh of
devices, of one process or, after ``parallel.mesh.
initialize_distributed``, of several (``parallel/``).  Files go in and
out as
in the reference: Y4M and raw planar YUV (``utils/videoio``), OpenEXR
(``utils/exr``), any container cv2 reads, through
``extract_frames_from_video`` and ``decompress_video(output_path=...)``;
the command line (``python -m new_bloom_filter_repo_tpu_torch.cli``,
with ``--device``), the bit-exact verification harness
(``verify_harness``), the stream report (``utils/streaminfo``), the
false-positive-rate experiments (``experiments``) and tracing
(``utils/profiling``, over ``torch.profiler``) are here too.  It never
imports ``jax``.
"""

__version__ = "0.1.0"

# The shared host library native/libnbf.so is built here, on import, once
# across processes and atomically (utils/native.ensure_built); a library
# that cannot be built or loaded raises now instead of leaving the codec
# on other paths.
from new_bloom_filter_repo_tpu_torch.utils import native as _native

_native.load()

from new_bloom_filter_repo_tpu_torch.models.bloom import (  # noqa: F401,E402
    RationalBloomFilter,
    StandardBloomFilter,
)

# The codec/video classes resolve lazily (PEP 562), like the reference
# package.
_LAZY = {
    "BloomFilterCompressor":
        "new_bloom_filter_repo_tpu_torch.models.binary_codec",
    "FixedVideoCompressor": "new_bloom_filter_repo_tpu_torch.models.video",
    "ImprovedVideoCompressor": "new_bloom_filter_repo_tpu_torch.models.video",
}

__all__ = ["RationalBloomFilter", "StandardBloomFilter", *sorted(_LAZY)]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
