""".bfvc container serialization.

Layout (reference: improved_video_compressor.py:398-406, 471-485): magic +
``<I`` frame count + per-frame ``<I`` length-prefixed payloads, all
little-endian.

Two profiles share the layout and differ only in magic and frame-record
flavor:

* ``b'BFVC'`` — reference-compatible: every payload is an *untyped*
  keyframe record (fixed_video_compressor.py:27-74).  Files written by the
  reference decode here and vice versa.
* ``b'BFV2'`` — this framework's full codec: every payload starts with a
  type byte (1 = keyframe, 0 = Bloom inter-frame), enabling the
  keyframe_interval scheduling the reference documents but never wired.
"""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

MAGIC_FIXED = b"BFVC"
MAGIC_BLOOM = b"BFV2"

_U32 = struct.Struct("<I")


def write_bfvc(path: str, payloads: List[bytes], magic: bytes = MAGIC_FIXED) -> int:
    """Write a container; returns total bytes written."""
    if len(magic) != 4:
        raise ValueError("magic must be 4 bytes")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    total = 0
    with open(path, "wb") as f:
        f.write(magic)
        f.write(_U32.pack(len(payloads)))
        total += 8
        for p in payloads:
            f.write(_U32.pack(len(p)))
            f.write(p)
            total += 4 + len(p)
    return total


def serialize_bfvc(payloads: List[bytes], magic: bytes = MAGIC_FIXED) -> bytes:
    out = [magic, _U32.pack(len(payloads))]
    for p in payloads:
        out.append(_U32.pack(len(p)))
        out.append(p)
    return b"".join(out)


def read_bfvc(path: str) -> Tuple[bytes, List[bytes]]:
    """Read a container; returns (magic, payloads)."""
    with open(path, "rb") as f:
        data = f.read()
    return parse_bfvc(data)


def parse_bfvc(data: bytes) -> Tuple[bytes, List[bytes]]:
    magic = data[:4]
    if magic not in (MAGIC_FIXED, MAGIC_BLOOM):
        raise ValueError(f"Invalid file format: {magic}")
    count = _U32.unpack_from(data, 4)[0]
    payloads = []
    off = 8
    for _ in range(count):
        ln = _U32.unpack_from(data, off)[0]
        off += 4
        payloads.append(data[off:off + ln])
        off += ln
    return magic, payloads
