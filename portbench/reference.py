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

A frame is compared as its planes: an interleaved frame is one plane,
an I420 frame its Y, U and V.  The configuration's layout, passed in and
never guessed from a frame, sets what the file holds.  ``"interleaved"``:
one record a frame.  ``"I420"``: the planar profile's type-5 header, then
the Y plane's records of every frame, then U's, then V's; each plane
sequence has its own keyframe schedule.  The header: ``<B`` 5, ``<H``
length and that many bytes of format (UTF-8), ``<I`` width, ``<I``
height, ``<I`` frame count, ``<B`` plane count, a ``<I`` record count a
plane.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

MAGIC = b"BFV2"
KEYFRAME_TYPES = (1, 11, 15)
PLANAR_TYPE = 5
# Every number compared, and its limit.  All are exact comparisons.
LIMITS = {"frames_wrong": 0, "records_off": 0, "keys_off": 0}

_U32 = struct.Struct("<I")
# A type-5 header after its format: width, height, frame count, planes.
_PLANAR = struct.Struct("<IIIB")


def digest(planes: Sequence) -> bytes:
    """SHA-256 of a frame's planes: each plane's shape, dtype and bytes,
    in order.  An interleaved frame is its one plane."""
    h = hashlib.sha256()
    for p in planes:
        a = np.ascontiguousarray(np.asarray(p))
        h.update(f"{a.shape}{a.dtype.str}".encode())
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


def parse_planar_header(record: bytes) -> Optional[dict]:
    """The fields of a type-5 header, or None when the record is not one:
    another type, a length past the end, bytes that are no UTF-8, or
    trailing bytes."""
    if len(record) < 3 or record[0] != PLANAR_TYPE:
        return None
    off = 3 + struct.unpack_from("<H", record, 1)[0]
    end = off + _PLANAR.size
    if end > len(record):
        return None
    try:
        fmt = record[3:off].decode("utf-8")
    except UnicodeDecodeError:
        return None
    width, height, frames, n = _PLANAR.unpack_from(record, off)
    if end + 4 * n != len(record):
        return None
    counts = list(struct.unpack_from(f"<{n}I", record, end))
    return {"format": fmt, "width": width, "height": height,
            "frame_count": frames, "plane_counts": counts}


def judge_planar(records: Optional[List[bytes]], frame_count: int,
                 scheduled: range) -> Dict[str, int]:
    """An I420 file of ``frame_count`` frames.  ``records_off`` adds up:
    1 for a first record that is no type-5 header or states another
    format than I420; else the distance of its frame count from
    ``frame_count``, of its plane count from 3, and of each plane's
    record count from ``frame_count``; and the distance of the file's
    record count from 1 + 3 ``frame_count``.  ``keys_off``: for each of
    the three plane sequences, the scheduled positions whose record
    (after the header, Y's, U's, V's at ``frame_count`` records each) is
    missing, empty or of a type that needs a previous frame.  A file
    that does not parse counts the whole clip in both."""
    n = frame_count
    if records is None:
        return {"records_off": 1 + 3 * n, "keys_off": 3 * len(scheduled)}
    header = parse_planar_header(records[0]) if records else None
    if header is None or header["format"] != "I420":
        off = 1
    else:
        counts = header["plane_counts"]
        off = (abs(header["frame_count"] - n) + abs(len(counts) - 3)
               + sum(abs(c - n) for c in counts))
    off += abs(len(records) - (1 + 3 * n))
    keys_off = 0
    for plane in range(3):
        for i in scheduled:
            j = 1 + plane * n + i
            keys_off += (j >= len(records) or not records[j]
                         or records[j][0] not in KEYFRAME_TYPES)
    return {"records_off": off, "keys_off": keys_off}


def judge_file(data: bytes, frame_count: int, keyframe_interval: int,
               layout: str = "interleaved") -> Dict[str, int]:
    """``records_off``: how far the file's record count is from the
    clip's frame count (the whole clip when the file does not parse);
    ``keys_off``: scheduled keyframe positions (every
    ``keyframe_interval``-th frame from 0) whose record is missing, empty
    or of a type that needs a previous frame.  For I420, as
    ``judge_planar`` counts them."""
    records = parse_records(data)
    scheduled = range(0, frame_count, keyframe_interval)
    if layout == "I420":
        return judge_planar(records, frame_count, scheduled)
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


def judge(planes: Sequence[Sequence], keyframe_interval: int,
          runs: Sequence[dict],
          layout: str = "interleaved") -> List[Dict[str, int]]:
    """Every number compared, for each round trip of ``runs``; each
    holds the stored file's bytes (``file``, None if compress failed)
    and the decoded frames' digests (``decoded``, None if the decode
    failed).  ``planes``: each frame of the clip as its planes, the frame
    itself or, for I420, its Y, U and V."""
    want = [digest(p) for p in planes]
    out = []
    for run in runs:
        numbers = judge_file(run["file"] or b"", len(planes),
                             keyframe_interval, layout)
        numbers["frames_wrong"] = judge_frames(want, run["decoded"])
        out.append(numbers)
    return out


def within_limits(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
