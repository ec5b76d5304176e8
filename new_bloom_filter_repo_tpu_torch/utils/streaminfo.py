"""Structural .bfvc stream attribution (CLI ``analyze-stream``).

Walks a container's records WITHOUT decoding payloads and reports
where the bytes live: per record type, per wrapped inner type, and per
section coding (raw / DEFLATE / binary rANS / byte rANS / order-1
context rANS / 2D-context rANS): which record families and entropy
coders carry the stream.  The port's copy of
``new_bloom_filter_repo_tpu.utils.streaminfo`` (host only).
"""

from __future__ import annotations

import struct
from typing import Dict, List

from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc

RECORD_NAMES = {
    fc.INTERFRAME: "bloom-inter",
    fc.KEYFRAME: "keyframe",
    fc.EMPTY: "empty",
    fc.BLOCKED: "blocked",
    fc.SPARSE: "sparse",
    fc.PLANAR: "planar-header",
    fc.MOTION: "motion",
    fc.BLOCKED_Z: "blocked-z",
    fc.RESIDUAL: "residual",
    fc.MOTION_HP: "motion-halfpel",
    fc.TILES: "motion-tiles",
    fc.FILTERED: "keyframe-filtered",
    fc.BLOCKED_S: "blocked-sectioned",
    fc.RESIDUAL_S: "residual-sectioned",
    fc.RESIDUAL_F: "residual-filtered",
    fc.KEYFRAME_S: "keyframe-sectioned",
    fc.REF_HP: "motion-multiref",
    fc.TILES_HP: "motion-tiles-halfpel",
    fc.ZOOM_G: "motion-zoom",
    fc.AVG2: "motion-avg2",
    fc.ROT_G: "motion-rotation",
}

CODING_NAMES = {0: "raw", 1: "deflate", 2: "binary-rans",
                3: "byte-rans", 4: "ctx-rans", 6: "2d-rans",
                7: "bitpacked-rans"}

_WRAPPERS = (fc.MOTION, fc.MOTION_HP, fc.TILES, fc.REF_HP,
             fc.TILES_HP, fc.ZOOM_G, fc.AVG2, fc.ROT_G)


def _skip_section(data: bytes, off: int, out: Dict[str, List[int]]):
    """Advance past one coded section, accumulating (count, bytes) per
    coding name.  Raises ValueError on truncation."""
    if off + 5 > len(data):
        raise ValueError("truncated section header")
    coding = data[off]
    stored = struct.unpack_from("<I", data, off + 1)[0]
    off += 5
    if coding:
        off += 4
    if coding in (2, 7):
        off += 1
    elif coding == 6:
        off += 4
    name = CODING_NAMES.get(coding, f"coding-{coding}")
    end = off + stored
    if end > len(data):
        raise ValueError("truncated section body")
    slot = out.setdefault(name, [0, 0])
    slot[0] += 1
    slot[1] += stored
    return end


def _inner_offset(payload: bytes) -> int:
    """Offset of the inner record of a motion wrapper (0 = not one)."""
    t = payload[0]
    if t in (fc.MOTION, fc.MOTION_HP):
        return 5
    if t == fc.REF_HP:
        return 6
    if t in (fc.TILES, fc.TILES_HP):
        _, _, off = fc.parse_motion_tiles(payload)
        return off
    if t == fc.ZOOM_G:
        return 14
    if t == fc.AVG2:
        return 3
    if t == fc.ROT_G:
        return 14
    return 0


def _walk_codings(payload: bytes, codings: Dict[str, List[int]]):
    """Accumulate section-coding stats of a (possibly wrapped)
    sectioned record; non-sectioned records are skipped."""
    off = _inner_offset(payload)
    t = payload[off]
    body = off + 1
    if t == fc.BLOCKED_S:
        pos = body + 20  # <f p, <I n, <f k, <I bitmap/witness bits
        for _ in range(3):
            pos = _skip_section(payload, pos, codings)
    elif t == fc.BLOCKED_Z:
        pos = body + 20
        for _ in range(2):
            pos = _skip_section(payload, pos, codings)
        vz = struct.unpack_from("<I", payload, pos)[0]
        slot = codings.setdefault("deflate", [0, 0])
        slot[0] += 1
        slot[1] += vz
    elif t == fc.RESIDUAL_S:
        _skip_section(payload, body, codings)
    elif t == fc.RESIDUAL_F:
        _skip_section(payload, body + 1, codings)
    elif t == fc.KEYFRAME_S:
        pos = body + 2 + 12  # filter_id, flag, h/w/itemsize
        flag = payload[body + 1]
        if flag:
            fmt_len = struct.unpack_from("<H", payload, pos)[0]
            pos += 2 + fmt_len
        if flag != 3:
            pos = _skip_section(payload, pos, codings)
        if flag in (1, 3):
            for _ in range(3):
                pos = _skip_section(payload, pos, codings)
                pos += 8  # <II plane shape


def attribute_stream(payloads: List[bytes]) -> Dict:
    """Byte attribution of a record list: totals per record type (the
    wrapper type when wrapped, with the inner type tallied separately)
    and per section coding.  Pure structural walk — nothing is
    decompressed."""
    by_type: Dict[str, List[int]] = {}
    inner: Dict[str, int] = {}
    codings: Dict[str, List[int]] = {}
    total = 0
    for p in payloads:
        if not p:
            raise ValueError("empty record in container")
        total += len(p)
        name = RECORD_NAMES.get(p[0], f"type-{p[0]}")
        slot = by_type.setdefault(name, [0, 0])
        slot[0] += 1
        slot[1] += len(p)
        off = _inner_offset(p)
        if off and off < len(p):
            iname = RECORD_NAMES.get(p[off], f"type-{p[off]}")
            inner[iname] = inner.get(iname, 0) + 1
        try:
            _walk_codings(p, codings)
        except (ValueError, struct.error, IndexError):
            codings.setdefault("unparsed", [0, 0])[0] += 1
    return {
        "total_bytes": total,
        "records": {k: {"count": c, "bytes": b,
                        "share": round(b / total, 4) if total else 0.0}
                    for k, (c, b) in sorted(
                        by_type.items(), key=lambda kv: -kv[1][1])},
        "wrapped_inner_types": inner,
        "section_codings": {k: {"count": c, "bytes": b}
                            for k, (c, b) in sorted(
                                codings.items(),
                                key=lambda kv: -kv[1][1])},
    }


def format_report(path: str, magic: bytes, info: Dict) -> str:
    lines = [f"{path}: magic {magic.decode('ascii', 'replace')}, "
             f"{info['total_bytes']} payload bytes"]
    lines.append(f"{'record type':<20}{'count':>7}{'bytes':>12}"
                 f"{'share':>8}")
    for name, row in info["records"].items():
        lines.append(f"{name:<20}{row['count']:>7}{row['bytes']:>12}"
                     f"{row['share']*100:>7.1f}%")
    if info["wrapped_inner_types"]:
        pairs = ", ".join(f"{k}={v}" for k, v in
                          sorted(info["wrapped_inner_types"].items()))
        lines.append(f"wrapped inner records: {pairs}")
    if info["section_codings"]:
        lines.append("section codings:")
        for name, row in info["section_codings"].items():
            lines.append(f"  {name:<14}{row['count']:>7}"
                         f"{row['bytes']:>12}")
    return "\n".join(lines)
