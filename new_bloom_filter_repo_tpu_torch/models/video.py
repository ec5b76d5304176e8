"""Public video compression API, on the blocked exact path.

The PyTorch port of ``new_bloom_filter_repo_tpu.models.video``, reduced
to the codec's main path: ``ImprovedVideoCompressor(mode="bloom",
profile="blocked", exact=True, motion=True)`` on uniform uint8 frames
with at most 3 channels.  Every device tensor lives on the ``device``
the compressor was built with; a CPU device runs the kernels' plain
twins, a CUDA device the hand-written kernels.  ``devices=`` (an int, a
``(dp, sp)`` tuple, ``"auto"`` or a ``parallel.mesh.Mesh``) shards each
chunk over frames and blocks on several devices of one process, with
the same bytes as one device.  The ``.bfvc`` bytes are the reference's:
for the same frames and options both packages write the same file, and
each decodes the other's.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
Queue 1 item: ``mode="keyframe"`` and ``exact=False`` (item 10),
``profile="planar"`` and the byte-view path for non-uint8 or wider than
3-channel frames (item 9), ``profile="bfv2"`` and its type-0 Bloom
records (item 10), meshes across processes (item 11), and file export
on decode (item 12).
"""

from __future__ import annotations

import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    home_device,
)
from new_bloom_filter_repo_tpu_torch.utils import container
from new_bloom_filter_repo_tpu_torch.utils.yuvframe import (
    YUVFrame,
    unwrap,
    yuv_info_of,
)

# Inter frames per device chunk.  Any value decodes any stream: chunking
# is not visible in the bytes.
_CHUNK = int(os.environ.get("NBF_CHUNK", "15"))


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP Queue 1 item {item})")


def add_yuv_info_to_frame(frame) -> YUVFrame:
    """Wrap an HxWx3 YUV array with exact plane copies."""
    if isinstance(frame, YUVFrame):
        return frame
    return YUVFrame(np.asarray(frame))


def verify_lossless(original_frames, decompressed_frames,
                    verbose: bool = False) -> Dict:
    """Bit-exact verification with the reference's result keys;
    'avg_difference' holds a true mean."""
    if len(original_frames) != len(decompressed_frames):
        return {
            "lossless": False,
            "reason": (f"Frame count mismatch: {len(original_frames)} vs "
                       f"{len(decompressed_frames)}"),
            "avg_difference": float("inf"),
        }
    exact = 0
    diff_frames = []
    frame_diffs = []
    max_diff, max_diff_frame = 0.0, -1
    for i, (o, d) in enumerate(zip(original_frames, decompressed_frames)):
        od, dd = unwrap(o), unwrap(d)
        if (od.shape == dd.shape and od.dtype == dd.dtype
                and od.tobytes() == dd.tobytes()):
            exact += 1
            frame_diffs.append(0.0)
            continue
        if od.shape != dd.shape:
            fd = float("inf")
        else:
            with np.errstate(invalid="ignore"):
                fd = float(np.nanmean(np.abs(od.astype(np.float64)
                                             - dd.astype(np.float64))))
            if np.isnan(fd):
                fd = float("inf")
        frame_diffs.append(fd)
        diff_frames.append(i)
        if fd > max_diff:
            max_diff, max_diff_frame = fd, i
    is_lossless = exact == len(original_frames)
    result = {
        "lossless": is_lossless,
        "exact_lossless": is_lossless,
        "avg_difference": float(np.mean(frame_diffs)) if frame_diffs else 0.0,
        "max_difference": max_diff,
        "max_diff_frame": max_diff_frame,
        "exact_frame_matches": exact,
        "total_frames": len(original_frames),
        "diff_frames": diff_frames,
    }
    if verbose:
        print(f"Lossless verification: {'SUCCESS' if is_lossless else 'FAILED'}")
        print(f"Exact frame matches: {exact}/{len(original_frames)}")
        if not is_lossless:
            print(f"Frames with differences: {len(diff_frames)}")
            print(f"Maximum difference: {max_diff} (frame {max_diff_frame})")
    return result


class ImprovedVideoCompressor:
    """The public facade on the blocked exact path.

    Keyframes every ``keyframe_interval`` frames, blocked rational-Bloom
    inter-frame records between them (container magic b'BFV2').
    ``device`` places every tensor of the pipeline (default CPU);
    ``devices`` shards the device stages over a mesh (None: one device;
    ``"auto"``: every card of ``device``'s type, CUDA by default; an int
    n: n distinct cards on frames; ``(dp, sp)``: dp*sp cards, sp of them
    on the blocks of a frame; or a ``Mesh``), and the compressor's
    ``device`` is then the mesh's first device.  ``prefetch`` uploads
    the next chunk while the current one computes (default on;
    ``NBF_PREFETCH=0`` turns it off).  The remaining parameters mirror
    the reference's constructor; the ones that only select paths not
    ported yet raise ``NotImplementedError``.
    """

    def __init__(self,
                 noise_tolerance: float = 10.0,
                 keyframe_interval: int = 30,
                 min_diff_threshold: float = 3.0,
                 max_diff_threshold: float = 30.0,
                 bloom_threshold_modifier: float = 1.0,
                 batch_size: Optional[int] = None,
                 num_threads: Optional[int] = None,
                 use_direct_yuv: bool = False,
                 verbose: bool = False,
                 mode: str = "bloom",
                 exact: bool = True,
                 profile: str = "blocked",
                 devices=None,
                 prefetch: Optional[bool] = None,
                 motion: bool = True,
                 device=None):
        if mode not in ("bloom", "keyframe"):
            raise ValueError(f"unknown mode: {mode!r}")
        if profile not in ("blocked", "bfv2", "planar"):
            raise ValueError(f"unknown profile: {profile!r}")
        if mode == "keyframe":
            raise _not_ported('mode="keyframe"', 10)
        if profile == "planar":
            raise _not_ported('profile="planar"', 9)
        if profile == "bfv2":
            raise _not_ported('profile="bfv2"', 10)
        if not exact:
            raise _not_ported("exact=False", 10)
        self.mesh = _resolve_mesh(
            devices, "cuda" if device is None else torch.device(device).type)
        self.device = home_device(self.mesh, device)
        self.noise_tolerance = noise_tolerance
        self.keyframe_interval = max(1, int(keyframe_interval))
        self.min_diff_threshold = min_diff_threshold
        self.max_diff_threshold = max_diff_threshold
        self.bloom_threshold_modifier = bloom_threshold_modifier
        self._chunk = _CHUNK if batch_size is None else int(batch_size)
        if self._chunk < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = self._chunk
        self.num_threads = int(num_threads or 0)
        self.use_direct_yuv = use_direct_yuv
        self.verbose = verbose
        self.mode = mode
        self.exact = exact
        self.profile = profile
        if prefetch is None:
            prefetch = os.environ.get("NBF_PREFETCH", "1") == "1"
        self.prefetch = bool(prefetch)
        self.motion = motion
        self._blocked_enc = blocked_pipeline.BlockedEncoder(
            num_threads=self.num_threads, motion=motion, device=self.device,
            mesh=self.mesh)
        self._blocked_dec = blocked_pipeline.BlockedDecoder(
            device=self.device, mesh=self.mesh)
        self._keyframe_zlib_level = 6

    # -- encoding ----------------------------------------------------------

    def _encode_frames(self, frames) -> tuple[List[bytes], int]:
        """Encode frames into typed records; returns (payloads, keyframes).
        Uniform uint8 clips with at most 3 channels go through the
        batched blocked pipeline; a single frame is one keyframe."""
        arrs = [np.asarray(unwrap(f)) for f in frames]
        infos = [yuv_info_of(f) for f in frames]
        a0 = arrs[0]
        if len(arrs) == 1 and a0.dtype == np.uint8:
            return [fc.encode_keyframe_best(a0, infos[0])], 1
        uniform = all(a.dtype == a0.dtype and a.shape == a0.shape
                      for a in arrs)
        if not uniform:
            raise _not_ported("frames of mixed dtype or shape", 10)
        if (a0.dtype != np.uint8 or a0.ndim not in (2, 3)
                or (a0.ndim == 3 and a0.shape[2] > 3)):
            raise _not_ported(
                "byte-view coding of non-uint8 or >3-channel frames", 9)
        return self._encode_frames_batched(arrs, infos)

    def _encode_frames_batched(self, arrs, infos
                               ) -> tuple[List[bytes], int]:
        """Batched encode through the blocked pipeline
        (models/blocked_pipeline.py): chunks of up to ``batch_size``
        inter frames, padded to that size.  Chunk i's host phase (the
        ``finish()`` closure) runs on ONE worker thread while the main
        thread drives chunk i+1's device phase; the single worker keeps
        host phases in submit order, so payload assembly is an in-order
        drain."""
        payloads: List[bytes] = []
        keyframes = 0
        # stream boundary: the type-18 zoom tracker must not carry an
        # anchor from a previous video
        self._blocked_enc.begin_stream()
        segments = _plan_segments(len(arrs), self.keyframe_interval,
                                  self._chunk)

        def stack_for(seg):
            _, s, e = seg
            cf = arrs[s:e]
            cf = cf + [cf[-1]] * (self._chunk - len(cf))
            return cf, blocked_pipeline.BlockedEncoder.stack_chunk(
                arrs[s - 1], cf, self.device)

        inflight = None  # (future, real): at most ONE queued host phase
        with ThreadPoolExecutor(max_workers=1) as ex:

            def drain(job, real):
                nonlocal keyframes
                chunk_payloads, kf = job.result()
                payloads.extend(chunk_payloads[:real])
                keyframes += kf

            pending: dict = {}
            for i, (kind, start, end) in enumerate(segments):
                if kind == "key":
                    def key_job(_a=arrs[start], _i=infos[start]):
                        return [fc.encode_keyframe_best(
                            _a, _i,
                            zlib_level=self._keyframe_zlib_level)], 1
                    job = ex.submit(key_job)
                    if inflight is not None:
                        drain(*inflight)
                    inflight = (job, 1)
                    continue
                real = end - start

                def keyframe_fn(j, _pos=start):
                    idx = _pos + j
                    return fc.encode_keyframe_best(
                        arrs[idx], infos[idx],
                        zlib_level=self._keyframe_zlib_level)

                chunk_frames, stacked = pending.pop(i, (None, None))
                if stacked is None:
                    chunk_frames, stacked = stack_for((kind, start, end))
                if self.prefetch:
                    for j in range(i + 1, len(segments)):
                        if segments[j][0] == "run":
                            if j not in pending:
                                pending[j] = stack_for(segments[j])
                            break

                finish = self._blocked_enc.encode_chunk_begin(
                    arrs[start - 1], chunk_frames, keyframe_fn,
                    stacked=stacked)
                job = ex.submit(finish)
                if inflight is not None:
                    drain(*inflight)
                inflight = (job, real)
            if inflight is not None:
                drain(*inflight)
        return payloads, keyframes

    def compress_video(self, frames: List, output_path: str = None,
                       input_color_space: str = "BGR") -> Dict:
        """Compress frames; optionally write a .bfvc container.  Same
        surface and stats dict as the reference's."""
        if not frames:
            raise ValueError("No frames provided for compression")
        start = time.time()
        if input_color_space.upper() == "YUV":
            self.use_direct_yuv = True
            frames = [f if hasattr(f, "yuv_info") else
                      add_yuv_info_to_frame(f) for f in frames]
        original_size = sum(f.nbytes for f in frames)
        payloads, keyframes = self._encode_frames(frames)
        magic = container.MAGIC_BLOOM
        if output_path:
            container.write_bfvc(output_path, payloads, magic)
            compressed_size = os.path.getsize(output_path)
        else:
            compressed_size = (8 + sum(4 + len(p) for p in payloads))
        ratio = compressed_size / original_size
        elapsed = time.time() - start
        results = {
            "frame_count": len(frames),
            "original_size": original_size,
            "compressed_size": compressed_size,
            "compression_ratio": ratio,
            "space_savings": 1.0 - ratio,
            "compression_time": elapsed,
            "frames_per_second": len(frames) / elapsed if elapsed > 0 else 0.0,
            "keyframes": keyframes,
            "keyframe_ratio": keyframes / len(frames),
            "output_path": output_path,
            "color_space": input_color_space,
            "overall_ratio": ratio,
        }
        if self.verbose:
            print(f"Compression Ratio: {ratio:.4f}  Time: {elapsed:.2f} s  "
                  f"FPS: {results['frames_per_second']:.2f}  "
                  f"Keyframes: {keyframes}")
        return results

    # -- decoding ----------------------------------------------------------

    def _decode_payloads(self, payloads: List[bytes], typed: bool):
        if not typed:
            raise _not_ported("decoding keyframe-mode (b'BFVC') files", 10)
        if payloads and fc.record_type(payloads[0]) == fc.PLANAR:
            raise _not_ported("decoding planar-profile streams", 9)

        def _inner_type(payload: bytes) -> int:
            t = fc.record_type(payload)
            if t in (fc.MOTION, fc.MOTION_HP):
                if len(payload) <= 5:
                    raise ValueError("truncated motion record")
                return payload[5]
            if t == fc.REF_HP:
                if len(payload) <= 6:
                    raise ValueError(
                        "truncated multi-reference motion record")
                return payload[6]
            if t in (fc.TILES, fc.TILES_HP):
                _, _, off = fc.parse_motion_tiles(payload)
                if len(payload) <= off:
                    raise ValueError("truncated tile-motion record")
                return payload[off]
            if t == fc.ZOOM_G:
                if len(payload) <= 14:
                    raise ValueError("truncated zoom-motion record")
                return payload[14]
            if t == fc.AVG2:
                if len(payload) <= 3:
                    raise ValueError("truncated avg2 record")
                return payload[3]
            if t == fc.ROT_G:
                if len(payload) <= 14:
                    raise ValueError("truncated rotation-motion record")
                return payload[14]
            return t

        def _is_device_inter(payload: bytes) -> bool:
            """Records the device run decoder handles (residual records
            apply on the host against the running reconstruction)."""
            return _inner_type(payload) in (
                fc.INTERFRAME, fc.EMPTY, fc.BLOCKED, fc.SPARSE,
                fc.BLOCKED_Z, fc.BLOCKED_S)

        frames = []
        prev: Optional[np.ndarray] = None
        prev_info: Optional[dict] = None
        # short reconstruction history for multi-reference (type 16)
        # prediction; hist[-1] is always `prev`
        hist: List[np.ndarray] = []

        def _advance(frame):
            """Chain bookkeeping shared by the run and residual paths:
            update prev/prev_info (planes rebuilt at the native geometry
            the previous record carried) and append the output frame."""
            nonlocal prev, prev_info
            prev = frame
            hist.append(frame)
            del hist[:-15]
            if prev_info is None:
                frames.append(prev)
                return
            fh, fw = frame.shape[:2]

            def native(ch, key):
                ph, pw = np.asarray(prev_info[key]).shape[:2]
                sy = max(1, fh // max(1, ph))
                sx = max(1, fw // max(1, pw))
                return frame[::sy, ::sx, ch].copy()

            prev_info = {
                "format": prev_info.get("format", "YUV444"),
                "y_plane": frame[:, :, 0].copy(),
                "u_plane": native(1, "u_plane"),
                "v_plane": native(2, "v_plane"),
            }
            frames.append(YUVFrame(prev, _copy_info(prev_info)))

        # Decode-run pipelining: a device run's frame pull is deferred
        # until the NEXT run's device work is issued, and consecutive
        # runs chain on the device-resident last frame.  Host-applied
        # records (keyframes, residuals) flush first: they need the
        # reconstruction on the host.
        run_pending = None   # finish() -> decoded frames of prior run
        chain_dev = None     # device last frame of that run

        def _flush_runs():
            nonlocal run_pending, chain_dev
            if run_pending is None:
                return
            fin, run_pending, chain_dev = run_pending, None, None
            for frame in fin():
                _advance(frame)

        def _check_byte_domain():
            if prev.dtype != np.uint8 or (prev.ndim == 3
                                          and prev.shape[2] > 3):
                raise _not_ported(
                    "decoding byte-view records of non-uint8 or "
                    ">3-channel frames", 9)

        i = 0
        while i < len(payloads):
            rtype = fc.record_type(payloads[i])
            if rtype in (fc.KEYFRAME, fc.FILTERED, fc.KEYFRAME_S):
                _flush_runs()
                if rtype == fc.KEYFRAME_S:
                    frame, info = fc.decode_keyframe_s(payloads[i],
                                                       offset=1)
                elif rtype == fc.FILTERED:
                    fid = payloads[i][1]
                    if fid not in (1, 2, 3):
                        raise ValueError(
                            f"unknown keyframe filter id: {fid}")
                    frame, info = fc.decode_keyframe(payloads[i],
                                                     offset=2,
                                                     filter_id=fid)
                else:
                    frame, info = fc.decode_keyframe(payloads[i],
                                                     offset=1)
                prev, prev_info = np.asarray(frame), _copy_info(info)
                hist.append(prev)
                del hist[:-15]
                frames.append(YUVFrame(prev, _copy_info(prev_info))
                              if prev_info is not None else prev)
                i += 1
                continue
            if rtype not in (fc.INTERFRAME, fc.EMPTY, fc.BLOCKED,
                             fc.SPARSE, fc.BLOCKED_Z, fc.BLOCKED_S,
                             fc.MOTION, fc.RESIDUAL, fc.RESIDUAL_S,
                             fc.RESIDUAL_F, fc.MOTION_HP, fc.TILES,
                             fc.REF_HP, fc.TILES_HP, fc.ZOOM_G, fc.AVG2,
                             fc.ROT_G):
                raise ValueError(f"Unknown frame type: {rtype}")
            if prev is None:
                raise ValueError("inter-frame record before any keyframe")
            _check_byte_domain()
            if rtype in (fc.MOTION_HP, fc.TILES, fc.REF_HP,
                         fc.TILES_HP, fc.ZOOM_G, fc.AVG2, fc.ROT_G) and \
                    _inner_type(payloads[i]) not in fc.RESIDUAL_TYPES:
                raise ValueError(
                    "half-pel/tile/multi-ref wrapper on non-residual "
                    "record")
            if _inner_type(payloads[i]) in fc.RESIDUAL_TYPES:
                _flush_runs()
                frame = self._apply_residual_record(payloads[i], rtype,
                                                    prev, hist)
                _advance(frame)
                i += 1
                continue
            j = i
            while (j < len(payloads)
                   and j - i < self._chunk
                   and _is_device_inter(payloads[j])):
                j += 1
            if j == i:
                # motion wrapper around a non-inter inner type: corrupt
                # stream — fail loudly rather than spin on an empty run
                raise ValueError(
                    f"motion record wraps invalid inner type "
                    f"{_inner_type(payloads[i])}")
            run = payloads[i:j]
            if any(self._is_legacy_bloom(p) for p in run):
                raise _not_ported("decoding BFV2 type-0 Bloom records", 10)
            real = len(run)
            seg = run + [fc.encode_empty_frame()] * (self._chunk - real)
            base_in = chain_dev if chain_dev is not None else prev
            last_dev, fin = self._blocked_dec.decode_run_begin(base_in, seg)

            def run_finish(_fin=fin, _real=real):
                return _fin()[:_real]

            _flush_runs()  # pull the prior run while this one computes
            run_pending, chain_dev = run_finish, last_dev
            i = j
        _flush_runs()
        return frames

    @staticmethod
    def _apply_residual_record(payload: bytes, rtype: int,
                               prev: np.ndarray, hist: List[np.ndarray]):
        """Reconstruct one host-applied residual record (types 8-20)
        against the running reconstruction ``prev`` and its history."""
        if rtype in (fc.TILES, fc.TILES_HP):
            tlog, tshifts, off = fc.parse_motion_tiles(payload)
            residual = fc.parse_residual_any(payload, off, prev.shape)
            pred = (fc.tile_predict_hp(prev, tshifts, tlog)
                    if rtype == fc.TILES_HP
                    else fc.tile_predict(prev, tshifts, tlog))
            return fc.apply_residual(pred, residual)
        if rtype in (fc.ZOOM_G, fc.ROT_G, fc.AVG2, fc.REF_HP):
            if rtype == fc.ZOOM_G:
                rb, *params, off = fc.parse_motion_zoom(payload)
                what = "zoom-motion record"
            elif rtype == fc.ROT_G:
                rb, *params, off = fc.parse_motion_rot(payload)
                what = "rotation record"
            elif rtype == fc.AVG2:
                rb, thr, off = fc.parse_motion_avg2(payload)
                what = "avg2 record"
            else:
                rb, sy, sx, off = fc.parse_motion_ref(payload)
                what = "multi-ref record"
            if rb > len(hist):
                raise ValueError(f"{what} needs {rb} frames of history, "
                                 f"have {len(hist)}")
            residual = fc.parse_residual_any(payload, off, prev.shape)
            if rtype == fc.ZOOM_G:
                pred = fc.zoom_predict(hist[-rb], *params)
            elif rtype == fc.ROT_G:
                pred = fc.rot_predict(hist[-rb], *params)
            elif rtype == fc.AVG2:
                pred = fc.avg2_predict(prev, hist[-rb], thr)
            else:
                return fc.apply_residual(hist[-rb], residual, sy, sx,
                                         halfpel=True)
            return fc.apply_residual(pred, residual)
        dy = dx = 0
        off = 0
        if rtype in (fc.MOTION, fc.MOTION_HP):
            dy, dx, off = fc.parse_motion(payload)
        residual = fc.parse_residual_any(payload, off, prev.shape)
        return fc.apply_residual(prev, residual, dy, dx,
                                 halfpel=rtype == fc.MOTION_HP)

    @staticmethod
    def _is_legacy_bloom(payload: bytes) -> bool:
        """Type-0 record with a non-empty witness: the BFV2 (non-blocked)
        rational-Bloom layout."""
        if fc.record_type(payload) != fc.INTERFRAME:
            return False
        witness_bits = struct.unpack_from("<I", payload, 17)[0]
        return witness_bits > 0

    def decompress_video(self, input_path: str = None,
                         output_path: Optional[str] = None,
                         compressed_frames: List[bytes] = None,
                         metadata: Dict = None) -> List[np.ndarray]:
        """Decompress from a .bfvc file or a raw payload list."""
        start = time.time()
        if output_path:
            raise _not_ported("file export on decode (utils/videoio)", 12)
        magic = container.MAGIC_FIXED
        if input_path:
            if not os.path.exists(input_path):
                raise FileNotFoundError(input_path)
            magic, compressed_frames = container.read_bfvc(input_path)
        if not compressed_frames:
            raise ValueError("No compressed frames provided")
        frames = self._decode_payloads(compressed_frames,
                                       typed=(magic == container.MAGIC_BLOOM))
        if self.verbose:
            dt = time.time() - start
            print(f"Decompressed {len(frames)} frames in {dt:.2f} seconds")
        return frames

    # -- verification --------------------------------------------------------

    def verify_lossless(self, original_frames, decompressed_frames) -> Dict:
        return verify_lossless(original_frames, decompressed_frames,
                               self.verbose)

    def add_yuv_info_to_frame(self, yuv_frame):
        return add_yuv_info_to_frame(yuv_frame)


def _plan_segments(total: int, keyframe_interval: int,
                   chunk: int = _CHUNK):
    """Chunking plan: scheduled keyframes at every ``keyframe_interval``
    frames, runs of inter frames between them capped at the device chunk
    size."""
    segments = []
    pos = 0
    while pos < total:
        if pos % keyframe_interval == 0:
            segments.append(("key", pos, pos + 1))
            pos += 1
            continue
        next_key = ((pos // keyframe_interval) + 1) * keyframe_interval
        run_end = min(total, next_key, pos + chunk)
        segments.append(("run", pos, run_end))
        pos = run_end
    return segments


def _resolve_mesh(devices, device_type: str = "cuda") -> Optional[Mesh]:
    """Turn the public ``devices`` parameter into a Mesh (or None).
    ``devices=1`` and ``(1, 1)`` mean one device: no mesh."""
    if devices is None:
        return None
    if isinstance(devices, Mesh):
        return devices
    if isinstance(devices, str):
        if devices == "auto":
            return auto_mesh(device_type=device_type)
    elif isinstance(devices, int) and not isinstance(devices, bool):
        return (auto_mesh(devices, device_type=device_type)
                if devices > 1 else None)
    elif isinstance(devices, (tuple, list)) and len(devices) == 2:
        dp, sp = int(devices[0]), int(devices[1])
        # (dp, sp): reserve an sp axis so oversized (4K/8K) frames shard
        # their block axis within a frame as well as across frames.
        return (auto_mesh(dp * sp, sp=sp, device_type=device_type)
                if dp * sp > 1 else None)
    raise ValueError(f"devices must be None, 'auto', an int, a (dp, sp) "
                     f"tuple, or a Mesh; got {devices!r}")


def _copy_info(info: Optional[dict]) -> Optional[dict]:
    if info is None:
        return None
    return {k: (v.copy() if hasattr(v, "copy") else v)
            for k, v in info.items()}
