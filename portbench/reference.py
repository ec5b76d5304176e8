"""The plain reference that decides a run's ``correct``.

A lossless archive stores a clip and gives it back: the reference
answer to "compress, then decompress" is the clip itself, byte for byte.
The stored file is held to the container layout and to the keyframe
schedule that the configuration states, read here from the file's own
bytes.  Plain NumPy and the standard library: nothing of the program,
of JAX or of PyTorch is imported, and nothing the program made is used
except the outputs that are judged.

The container (``.bfvc``): 4 magic bytes, ``<I`` record count, then per
frame a ``<I`` length and that many bytes.  A file of the inter-frame
profiles has magic ``BFV2`` and starts every record with a type byte;
types 1 (keyframe), 11 (spatially filtered keyframe) and 15 (sectioned
keyframe) decode without a previous frame, and those are the records a
scheduled keyframe may hold.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

MAGIC = b"BFV2"
KEYFRAME_TYPES = (1, 11, 15)
# Every number compared, and its limit.  All are exact comparisons.
LIMITS = {"frames_wrong": 0, "records_off": 0, "keys_off": 0}

_U32 = struct.Struct("<I")


def frame_digest(frame) -> bytes:
    """SHA-256 of a frame's shape, dtype and bytes."""
    a = np.ascontiguousarray(np.asarray(frame))
    h = hashlib.sha256(f"{a.shape}{a.dtype.str}".encode())
    h.update(memoryview(a).cast("B"))
    return h.digest()


def parse_records(data: bytes) -> Optional[List[bytes]]:
    """The records of a ``BFV2`` container, or None when the bytes are
    not one: another magic, a length past the end, or trailing bytes."""
    if len(data) < 8 or data[:4] != MAGIC:
        return None
    count = _U32.unpack_from(data, 4)[0]
    off, records = 8, []
    for _ in range(count):
        if off + 4 > len(data):
            return None
        ln = _U32.unpack_from(data, off)[0]
        off += 4
        if off + ln > len(data):
            return None
        records.append(data[off:off + ln])
        off += ln
    return records if off == len(data) else None


def judge_file(data: bytes, frame_count: int,
               keyframe_interval: int) -> Dict[str, int]:
    """``records_off``: how far the file's record count is from the
    clip's frame count (the whole clip when the file does not parse);
    ``keys_off``: scheduled keyframe positions (every
    ``keyframe_interval``-th frame from 0) whose record is missing, empty
    or of a type that needs a previous frame."""
    records = parse_records(data)
    scheduled = range(0, frame_count, keyframe_interval)
    if records is None:
        return {"records_off": frame_count, "keys_off": len(scheduled)}
    keys_off = sum(1 for i in scheduled
                   if i >= len(records) or not records[i]
                   or records[i][0] not in KEYFRAME_TYPES)
    return {"records_off": abs(len(records) - frame_count),
            "keys_off": keys_off}


def judge_frames(clip_digests: Sequence[bytes],
                 decoded_digests: Optional[Sequence[bytes]]) -> int:
    """Frames of the clip that the decode did not give back exactly: a
    frame that differs, or is missing, counts; so does every frame of a
    decode that gave no answer (None)."""
    if decoded_digests is None:
        return len(clip_digests)
    wrong = sum(1 for a, b in zip(clip_digests, decoded_digests) if a != b)
    return wrong + abs(len(clip_digests) - len(decoded_digests))


def judge(clip: Sequence[np.ndarray], keyframe_interval: int,
          runs: Sequence[dict]) -> List[Dict[str, int]]:
    """Every number compared, for each round trip of ``runs``; each
    holds the stored file's bytes (``file``, None if compress failed)
    and the digests of the decoded frames (``decoded``, None if the
    decode failed)."""
    want = [frame_digest(f) for f in clip]
    keys = len(range(0, len(clip), keyframe_interval))
    out = []
    for run in runs:
        if run["file"] is None:
            numbers = {"records_off": len(clip), "keys_off": keys}
        else:
            numbers = judge_file(run["file"], len(clip), keyframe_interval)
        numbers["frames_wrong"] = judge_frames(want, run["decoded"])
        out.append(numbers)
    return out


def within_limits(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
