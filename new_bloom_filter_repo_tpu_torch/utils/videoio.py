"""Host video I/O: Y4M parsing (first-party) and OpenCV-backed containers.

The port's copy of ``new_bloom_filter_repo_tpu.utils.videoio`` (host
only; the same file bytes in and out).  Y4M and raw planar YUV get
first-party readers and writers (trivial raw formats that must not
depend on cv2), while arbitrary containers (mp4 etc.) go through cv2
when it is installed; without it those raise ``RuntimeError`` by name.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

try:
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None


def _require_cv2():
    if _cv2 is None:
        raise RuntimeError(
            "OpenCV is not installed; only .y4m/.yuv files are supported "
            "without it")
    return _cv2


# ---------------------------------------------------------------------------
# Y4M
# ---------------------------------------------------------------------------

_Y4M_MAGIC = b"YUV4MPEG2"


def read_y4m(path: str, max_frames: int = 0):
    """Parse a Y4M file into (frames, params).

    Returns a list of YUV frames: HxWx3 uint8 for 444, or dict of planes
    upsampled to 444 for 420/422 (chroma replicated — losslessly invertible
    because the original planes are also returned in params['planes']).

    For the codec pipeline we return HxWx3 YUV444 arrays; subsampled input
    planes are carried in params so a bit-exact writer can reconstruct the
    original file.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_Y4M_MAGIC):
        raise ValueError(f"not a Y4M file: {path}")
    hdr_end = data.index(b"\n")
    header = data[:hdr_end].decode("ascii", errors="replace")
    m_w = re.search(r" W(\d+)", header)
    m_h = re.search(r" H(\d+)", header)
    m_c = re.search(r" C(\S+)", header)
    m_f = re.search(r" F(\d+):(\d+)", header)
    if not (m_w and m_h):
        raise ValueError(f"Y4M header missing dimensions: {header}")
    w, h = int(m_w.group(1)), int(m_h.group(1))
    colorspace = m_c.group(1) if m_c else "420"
    fps = (int(m_f.group(1)), int(m_f.group(2))) if m_f else (25, 1)

    if colorspace.startswith("420"):
        cw, ch = w // 2, h // 2
    elif colorspace.startswith("422"):
        cw, ch = w // 2, h
    elif colorspace.startswith("444"):
        cw, ch = w, h
    elif colorspace.startswith("mono"):
        cw, ch = 0, 0
    else:
        raise ValueError(f"unsupported Y4M colorspace: {colorspace}")

    frame_size = h * w + 2 * cw * ch
    frames = []
    planes = []
    off = hdr_end + 1
    while off < len(data):
        nl = data.index(b"\n", off)
        if not data[off:nl].startswith(b"FRAME"):
            raise ValueError("bad Y4M frame marker")
        off = nl + 1
        raw = data[off:off + frame_size]
        if len(raw) < frame_size:
            break
        off += frame_size
        y = np.frombuffer(raw[: h * w], dtype=np.uint8).reshape(h, w)
        if cw:
            u = np.frombuffer(raw[h * w: h * w + cw * ch],
                              dtype=np.uint8).reshape(ch, cw)
            v = np.frombuffer(raw[h * w + cw * ch:], dtype=np.uint8
                              ).reshape(ch, cw)
            u444 = np.repeat(np.repeat(u, h // ch, axis=0), w // cw, axis=1)
            v444 = np.repeat(np.repeat(v, h // ch, axis=0), w // cw, axis=1)
            frames.append(np.stack([y, u444, v444], axis=-1))
            planes.append((y, u, v))
        else:
            frames.append(y.copy())
            planes.append((y,))
        if max_frames and len(frames) >= max_frames:
            break
    params = {"width": w, "height": h, "colorspace": colorspace,
              "fps": fps, "header": header, "planes": planes}
    return frames, params


def write_y4m(path: str, planes_list, width: int, height: int,
              colorspace: str = "420jpeg", fps=(25, 1)) -> None:
    """Write raw YUV planes back to a Y4M file."""
    with open(path, "wb") as f:
        f.write(_Y4M_MAGIC +
                f" W{width} H{height} F{fps[0]}:{fps[1]} Ip A0:0 "
                f"C{colorspace}\n".encode("ascii"))
        for planes in planes_list:
            f.write(b"FRAME\n")
            for p in planes:
                f.write(np.ascontiguousarray(p, dtype=np.uint8).tobytes())


# ---------------------------------------------------------------------------
# Raw planar YUV (.yuv) — the process-yuv CLI path
# ---------------------------------------------------------------------------

_YUV_LAYOUTS = {
    "I420": (2, 2), "YV12": (2, 2), "YUV422": (2, 1), "YUV444": (1, 1),
}


def read_raw_yuv(path: str, width: int, height: int, fmt: str = "I420",
                 max_frames: int = 0, frame_step: int = 1) -> List:
    """Read a headerless planar YUV file into YUVFrame wrappers.

    Each frame's ``.data`` view is an HxWx3 YUV444 uint8 array (chroma
    replicated for subsampled formats) while ``.yuv_info`` carries the
    file's ORIGINAL subsampled planes (canonical Y/U/V order — YV12's
    swapped layout is normalized on read and restored on write), so a
    planar pipeline can round-trip the raw bytes exactly.
    """
    from new_bloom_filter_repo_tpu_torch.utils.yuvframe import YUVFrame
    if fmt not in _YUV_LAYOUTS:
        raise ValueError(f"unsupported YUV format: {fmt}")
    sx, sy = _YUV_LAYOUTS[fmt]
    cw, ch = width // sx, height // sy
    frame_size = width * height + 2 * cw * ch
    frames = []
    with open(path, "rb") as f:
        idx = 0
        while True:
            raw = f.read(frame_size)
            if len(raw) < frame_size:
                break
            if idx % frame_step == 0:
                y = np.frombuffer(raw[: width * height], dtype=np.uint8
                                  ).reshape(height, width)
                u = np.frombuffer(raw[width * height: width * height + cw * ch],
                                  dtype=np.uint8).reshape(ch, cw)
                v = np.frombuffer(raw[width * height + cw * ch:],
                                  dtype=np.uint8).reshape(ch, cw)
                if fmt == "YV12":  # V before U
                    u, v = v, u
                u444 = np.repeat(np.repeat(u, sy, axis=0), sx, axis=1)
                v444 = np.repeat(np.repeat(v, sy, axis=0), sx, axis=1)
                frames.append(YUVFrame(
                    np.stack([y, u444, v444], axis=-1),
                    {"format": fmt, "y_plane": y.copy(),
                     "u_plane": u.copy(), "v_plane": v.copy()}))
                if max_frames and len(frames) >= max_frames:
                    break
            idx += 1
    return frames


def write_raw_yuv(path: str, frames, fmt: str = None) -> str:
    """Write YUVFrames' native planes back to a headerless planar file —
    the byte-exact inverse of :func:`read_raw_yuv`."""
    from new_bloom_filter_repo_tpu_torch.utils.yuvframe import yuv_info_of
    with open(path, "wb") as f:
        for frame in frames:
            info = yuv_info_of(frame)
            if info is None:
                raise ValueError(
                    "frame carries no yuv_info planes; planar export "
                    "requires YUV input (read_raw_yuv/read_y4m)")
            ffmt = fmt or info.get("format", "YUV444")
            y = np.asarray(info["y_plane"], dtype=np.uint8)
            u = np.asarray(info["u_plane"], dtype=np.uint8)
            v = np.asarray(info["v_plane"], dtype=np.uint8)
            if ffmt == "YV12":
                u, v = v, u
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
    return path


# ---------------------------------------------------------------------------
# OpenCV-backed generic containers
# ---------------------------------------------------------------------------

def open_video_frames(video_path: str, max_frames: int = 0,
                      target_fps: Optional[float] = None,
                      scale_factor: float = 1.0) -> List[np.ndarray]:
    """Extract BGR frames from any cv2-readable container
    (reference: improved_video_compressor.py:583-669)."""
    if not os.path.exists(video_path):
        raise ValueError(f"Video file not found: {video_path}")
    if video_path.lower().endswith(".y4m") and _cv2 is None:
        frames, _ = read_y4m(video_path, max_frames)
        return frames
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"Could not open video: {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if max_frames <= 0 or max_frames > total:
        max_frames = total if total > 0 else (max_frames or 1 << 30)
    step = 1
    if target_fps is not None and fps and target_fps < fps:
        step = max(1, round(fps / target_fps))
    frames = []
    idx = 0
    while len(frames) < max_frames:
        ret, frame = cap.read()
        if not ret:
            break
        if idx % step == 0:
            if scale_factor != 1.0:
                frame = cv2.resize(
                    frame, (int(frame.shape[1] * scale_factor),
                            int(frame.shape[0] * scale_factor)))
            frames.append(frame)
        idx += 1
    cap.release()
    return frames


def write_video_frames(frames, output_path: str, fps: int = 30,
                       is_color: bool = True) -> str:
    """Write frames with cv2.VideoWriter (mp4v — preview, not lossless;
    reference: improved_video_compressor.py:552)."""
    cv2 = _require_cv2()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                          fps, (w, h), isColor=is_color)
    if not out.isOpened():
        raise ValueError(f"Could not create video writer for {output_path}")
    for f in frames:
        out.write(np.asarray(f))
    out.release()
    return output_path
