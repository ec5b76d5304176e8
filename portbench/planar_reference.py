"""The plain reference of a lossless planar round trip: what
``decompress_video`` must give back for raw 8-bit 4:2:0 frames, and the
shape of the file that holds them.

A lossless planar decode returns each frame's Y, U and V planes as they
went in, and a 4:4:4 view beside them: Y, then U and V with each chroma
sample repeated over the block of luma samples it covers (2x2 for
I420), stacked on a last axis of 3.  The file holds a type-5 header,
then each plane's sequence of records, Y's, U's and V's, a record a
frame; each sequence has its own keyframe schedule, a keyframe record at
every ``keyframe_interval``-th frame from 0.

Plain PyTorch and NumPy: nothing of the program or of JAX is imported.
The container and header layouts are read by ``reference.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import reference

PLANES = ("y", "u", "v")


def view_444(y, u, v) -> np.ndarray:
    """The 4:4:4 view of one frame's planes: HxWx3 uint8, Y and the
    chroma planes repeated over their blocks (``torch.repeat_interleave``
    along rows, then columns)."""
    ty = torch.from_numpy(np.ascontiguousarray(y))
    out = [ty]
    for c in (u, v):
        tc = torch.from_numpy(np.ascontiguousarray(c))
        ry, rx = ty.shape[0] // tc.shape[0], ty.shape[1] // tc.shape[1]
        out.append(tc.repeat_interleave(ry, 0).repeat_interleave(rx, 1))
    return torch.stack(out, dim=-1).numpy()


def decoded(planes: Sequence[Sequence[np.ndarray]]) -> List[dict]:
    """What a lossless decode of the frames ``planes`` (each its Y, U
    and V) returns, a frame at a time: the planes (``y``, ``u``, ``v``)
    and the 4:4:4 ``view``."""
    return [dict(zip(PLANES, (np.asarray(p) for p in ps)),
                 view=view_444(*ps)) for ps in planes]


def container(frame_count: int, keyframe_interval: int, width: int,
              height: int, fmt: str = "I420") -> dict:
    """The shape of a planar file of ``frame_count`` frames: its header's
    fields, its record count (the header and 3 ``frame_count``), and the
    keyframe positions of each plane sequence."""
    keys = list(range(0, frame_count, keyframe_interval))
    return {"header": {"format": fmt, "width": width, "height": height,
                       "frame_count": frame_count,
                       "plane_counts": [frame_count] * 3},
            "records": 1 + 3 * frame_count,
            "keyframes": {p: keys for p in PLANES}}


def shape_of(data: bytes) -> Dict:
    """The same shape read from a file's bytes: the type-5 header's
    fields (None where the first record is none), the record count, and,
    for each plane sequence, the positions whose record is a keyframe
    (type 1, 11 or 15)."""
    records = reference.parse_records(data)
    if records is None:
        raise ValueError("not a BFV2 container")
    header = reference.parse_planar_header(records[0]) if records else None
    counts = header["plane_counts"] if header else []
    keyframes, pos = {}, 1
    for plane, n in zip(PLANES, counts):
        keyframes[plane] = [i for i, r in enumerate(records[pos:pos + n])
                            if r and r[0] in reference.KEYFRAME_TYPES]
        pos += n
    return {"header": header, "records": len(records),
            "keyframes": keyframes}
