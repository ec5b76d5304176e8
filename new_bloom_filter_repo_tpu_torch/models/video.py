"""Public video compression API.

The PyTorch port of ``new_bloom_filter_repo_tpu.models.video``:

* :class:`FixedVideoCompressor` — the keyframe-only codec: every frame
  an untyped zlib keyframe record (container magic b'BFVC').
* :class:`ImprovedVideoCompressor` — the facade.  ``mode="bloom"``
  writes keyframes every ``keyframe_interval`` frames and Bloom-coded
  inter-frame records between them (magic b'BFV2'); ``mode="keyframe"``
  writes :class:`FixedVideoCompressor`'s b'BFVC' files.  Profiles:
  ``"blocked"`` (the blocked records, through the hand-written kernels
  of ``ops/blocked.py``; uint16, float32 HDR and >3-channel frames are
  inter-coded on their raw bytes, the byte view), ``"bfv2"`` (type-0
  Bloom records, through the torch ops of ``models/gop.py``) and
  ``"planar"`` (each native Y/U/V plane sequence through the blocked
  path).  ``exact=False``, mixed dtypes or shapes and single frames take
  the per-frame loop.

Every device tensor lives on the ``device`` the compressor was built
with; a CPU device runs the kernels' plain twins, a CUDA device the
hand-written kernels and every torch op on the card.  ``devices=`` (an
int, a ``(dp, sp)`` tuple, ``"auto"`` or a ``parallel.mesh.Mesh``)
shards each chunk over frames (and, blocked profile, blocks) on several
devices, with the same bytes as one device; after
``parallel.mesh.initialize_distributed`` the mesh may span several
processes, which all make the same calls on the same frames and all
write the same file (blocked, planar and byte view; not ``"bfv2"``).  The
``.bfvc`` bytes are the reference's: for the same frames and options
both packages write the same file, and each decodes the other's.

Files go in through :meth:`ImprovedVideoCompressor.extract_frames_from_video`
(Y4M, raw planar YUV, EXR, and any container cv2 reads) and come out
through ``decompress_video(output_path=...)``: ``.yuv`` and ``.y4m``
are written from the decoded native planes, byte for byte the input
file's; any other extension is a cv2 preview.  Colour conversions on
those paths run ``ops/color.py`` on the compressor's device (integer
arithmetic: a card and the CPU give the same bytes).
"""

from __future__ import annotations

import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.models import gop as gop_mod
from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
    BloomFilterCompressor,
    _filter_scalars,
)
from new_bloom_filter_repo_tpu_torch.models.bloom import (
    optimal_compression_params,
)
from new_bloom_filter_repo_tpu_torch.ops import bitpack, bloom_core
from new_bloom_filter_repo_tpu_torch.ops import color as color_ops
from new_bloom_filter_repo_tpu_torch.ops import diff as diff_ops
from new_bloom_filter_repo_tpu_torch.ops import median as median_ops
from new_bloom_filter_repo_tpu_torch.ops.hashtables import get_hash_tables
from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch
from new_bloom_filter_repo_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    home_device,
)
from new_bloom_filter_repo_tpu_torch.utils import container, videoio
from new_bloom_filter_repo_tpu_torch.utils.yuvframe import (
    YUVFrame,
    unwrap,
    yuv_info_of,
)

# Inter frames per device chunk.  Any value decodes any stream: chunking
# is not visible in the bytes.
_CHUNK = int(os.environ.get("NBF_CHUNK", "15"))

# Wrappers of host-predicted residuals the encoder never emits for the
# byte view, and their names in the decoder's error text.
_NOT_BYTE_DOMAIN = {fc.TILES: "tile-motion", fc.TILES_HP: "tile-motion",
                    fc.ZOOM_G: "zoom-motion", fc.ROT_G: "rotation",
                    fc.AVG2: "avg2", fc.REF_HP: "multi-ref"}


def add_yuv_info_to_frame(frame) -> YUVFrame:
    """Wrap an HxWx3 YUV array with exact plane copies."""
    if isinstance(frame, YUVFrame):
        return frame
    return YUVFrame(np.asarray(frame))


def default_color_space(video_path: str) -> str:
    """Working color space when the caller doesn't specify one: YUV for
    native-YUV containers (.y4m/.yuv) so compress -> decompress
    reproduces the file bytes exactly, else BGR."""
    return ("YUV" if video_path.lower().endswith((".y4m", ".yuv"))
            else "BGR")


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


class FixedVideoCompressor:
    """Keyframe-only lossless codec: every frame an untyped zlib
    keyframe record, byte-compatible with the reference's live path.
    Host only.  ``num_threads`` sizes the native threaded-DEFLATE pool
    (0/None = all host cores)."""

    def __init__(self, verbose: bool = True,
                 num_threads: Optional[int] = None):
        self.verbose = verbose
        self.num_threads = int(num_threads or 0)

    def compress_frame(self, frame) -> bytes:
        return fc.encode_keyframe(unwrap(frame), yuv_info_of(frame),
                                  typed=False)

    def decompress_frame(self, compressed_data: bytes):
        frame, yuv_info = fc.decode_keyframe(compressed_data)
        if yuv_info is not None:
            return YUVFrame(frame, yuv_info)
        return frame

    def compress_video(self, frames) -> List[bytes]:
        if self.verbose:
            print(f"Compressing {len(frames)} frames")
        return fc.encode_keyframes_batch(
            [unwrap(f) for f in frames],
            [yuv_info_of(f) for f in frames], typed=False,
            threads=self.num_threads)

    def decompress_video(self, compressed_frames) -> List[np.ndarray]:
        if self.verbose:
            print(f"Decompressing {len(compressed_frames)} frames")
        return [self.decompress_frame(d) for d in compressed_frames]

    def verify_lossless(self, original_frames, decompressed_frames) -> Dict:
        return verify_lossless(original_frames, decompressed_frames,
                               self.verbose)

    def add_yuv_info_to_frame(self, yuv_frame):
        return add_yuv_info_to_frame(yuv_frame)


class ImprovedVideoCompressor:
    """The public facade.

    ``mode="bloom"`` (default): keyframes every ``keyframe_interval``
    frames, rational-Bloom inter-frame records between them (container
    magic b'BFV2'); ``mode="keyframe"``: every frame an untyped keyframe
    (b'BFVC').  ``profile``: ``"blocked"``, ``"bfv2"`` or ``"planar"``
    (module docstring).  ``exact=False`` thresholds the gray/Y change
    against the frame's noise (near-lossless; decode equals the
    encoder's own reconstruction).  ``device`` places every tensor of
    the pipeline (default: the current CUDA card; without a card, pass
    ``device="cpu"``, or the constructor raises); ``devices`` shards the
    device stages over a mesh (None: one device; ``"auto"``: every card of
    ``device``'s type, CUDA by default; an int n: n distinct cards on
    frames; ``(dp, sp)``: dp*sp cards, sp of them on the blocks of a
    frame; or a ``Mesh``), and the compressor's ``device`` is then the
    mesh's first device.  ``prefetch`` uploads the next chunk while the
    current one computes (default on; ``NBF_PREFETCH=0`` turns it off).
    The remaining parameters mirror the reference's constructor.
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
        self.mesh = _resolve_mesh(
            devices, "cuda" if device is None else torch.device(device).type)
        self.device = home_device(self.mesh, device)
        if profile == "bfv2" and self.mesh is not None \
                and self.mesh.multiproc:
            raise ValueError('profile="bfv2" shards over the devices of one '
                             'process; a mesh over several processes serves '
                             'the blocked and planar profiles')
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
        self.compressor = FixedVideoCompressor(verbose=verbose,
                                               num_threads=num_threads)
        self.bloom_compressor = BloomFilterCompressor(
            verbose=False, seed_set="video", device=self.device)
        if prefetch is None:
            prefetch = os.environ.get("NBF_PREFETCH", "1") == "1"
        self.prefetch = bool(prefetch)
        self.motion = motion
        self._blocked_enc = blocked_pipeline.BlockedEncoder(
            num_threads=self.num_threads, motion=motion, device=self.device,
            mesh=self.mesh)
        self._blocked_dec = blocked_pipeline.BlockedDecoder(
            device=self.device, mesh=self.mesh)
        # Bloom-mode keyframes use a faster DEFLATE level (any level
        # decodes identically); level 9 keeps keyframe mode's files
        # byte-identical to the reference's.
        self._keyframe_zlib_level = 6 if mode == "bloom" else 9

    def _upload(self, arr) -> torch.Tensor:
        """A host frame (or plane) as a tensor on this compressor's
        device."""
        if torch.is_tensor(arr):
            return arr.to(self.device)
        a = np.require(np.asarray(arr), requirements=["C", "W"])
        return torch.from_numpy(a).to(self.device)

    # -- encoding ----------------------------------------------------------

    def _frame_threshold(self, gray_like) -> float:
        """Adaptive diff threshold from the frame's noise, scaled by
        bloom_threshold_modifier."""
        thr = median_ops.adaptive_threshold(
            self._upload(gray_like), self.noise_tolerance,
            self.min_diff_threshold, self.max_diff_threshold)
        return thr * self.bloom_threshold_modifier

    def _encode_frames(self, frames) -> tuple[List[bytes], int]:
        """Encode frames into typed records; returns (payloads, keyframes).

        Uniform uint8 clips with at most 3 channels in exact mode go
        through the batched blocked pipeline.  Uniform clips of any other
        fixed-size dtype (uint16, float32 HDR) or with more than 3
        channels run the same pipeline on the BYTE view: diff masks and
        witness values over each frame's raw bytes viewed as an (H,
        row_bytes) uint8 image, bit-pattern exact by construction.
        ``profile="bfv2"`` batches uniform uint8 clips through the gop
        stages.  Mixed dtypes/shapes, single frames and near-lossless
        mode use the per-frame loop."""
        arrs = [np.asarray(unwrap(f)) for f in frames]
        uniform = all(
            a.dtype == arrs[0].dtype and a.shape == arrs[0].shape
            for a in arrs)
        if (self.exact and uniform and len(frames) > 1
                and self.profile in ("blocked", "planar")):
            infos = [yuv_info_of(f) for f in frames]
            a0 = arrs[0]
            packable = (a0.dtype == np.uint8
                        and (a0.ndim == 2 or a0.shape[2] <= 3))
            if packable:
                return self._encode_frames_batched(arrs, infos)
            if a0.dtype.kind in "uif" and a0.ndim in (2, 3):
                return self._encode_frames_batched(arrs, infos,
                                                   byte_view=True)
        if (self.exact and uniform and len(frames) > 1
                and self.profile == "bfv2" and arrs[0].dtype == np.uint8
                and arrs[0].ndim in (2, 3)):
            infos = [yuv_info_of(f) for f in frames]
            return self._encode_frames_batched_bfv2(arrs, infos)
        return self._encode_frames_loop(frames)

    @staticmethod
    def _byte_view(arr: np.ndarray) -> np.ndarray:
        """Raw bytes of a frame as an (H, row_bytes) uint8 image."""
        a = np.ascontiguousarray(arr)
        return a.view(np.uint8).reshape(a.shape[0], -1)

    def _encode_frames_batched(self, arrs, infos, byte_view: bool = False
                               ) -> tuple[List[bytes], int]:
        """Batched encode through the blocked pipeline
        (models/blocked_pipeline.py): chunks of up to ``batch_size``
        inter frames, padded to that size.  Chunk i's host phase (the
        ``finish()`` closure) runs on ONE worker thread while the main
        thread drives chunk i+1's device phase; the single worker keeps
        host phases in submit order, so payload assembly is an in-order
        drain.  ``NBF_OVERLAP=0`` pins the serial schedule: every job
        runs inline, in the same order, to the same bytes.
        ``byte_view``: the device work runs on raw frame bytes;
        keyframes keep the original dtype."""
        payloads: List[bytes] = []
        keyframes = 0
        # stream boundary: the type-18 zoom tracker must not carry an
        # anchor from a previous video or plane sequence
        self._blocked_enc.begin_stream()
        darrs = [self._byte_view(a) for a in arrs] if byte_view else arrs
        segments = _plan_segments(len(arrs), self.keyframe_interval,
                                  self._chunk)

        def stack_for(seg):
            _, s, e = seg
            cf = darrs[s:e]
            cf = cf + [cf[-1]] * (self._chunk - len(cf))
            return cf, blocked_pipeline.BlockedEncoder.stack_chunk(
                darrs[s - 1], cf, self.device)

        overlap = os.environ.get("NBF_OVERLAP", "1") == "1"
        inflight = None  # (future or thunk, real): at most ONE queued
        with ThreadPoolExecutor(max_workers=1) as ex:

            def drain(job, real):
                nonlocal keyframes
                chunk_payloads, kf = job.result() if overlap else job()
                payloads.extend(chunk_payloads[:real])
                keyframes += kf

            pending: dict = {}
            for i, (kind, start, end) in enumerate(segments):
                if kind == "key":
                    def key_job(_a=arrs[start], _i=infos[start]):
                        return [fc.encode_keyframe_best(
                            _a, _i,
                            zlib_level=self._keyframe_zlib_level)], 1
                    job = ex.submit(key_job) if overlap else key_job
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
                    darrs[start - 1], chunk_frames, keyframe_fn,
                    stacked=stacked, byte_view=byte_view)
                job = ex.submit(finish) if overlap else finish
                if inflight is not None:
                    drain(*inflight)
                inflight = (job, real)
            if inflight is not None:
                drain(*inflight)
        return payloads, keyframes

    def _encode_frames_batched_bfv2(self, arrs, infos
                                    ) -> tuple[List[bytes], int]:
        """Batched encode for the type-0 record profile: ``gop_masks``
        and ``gop_encode`` run whole chunks on the device, and the host
        assembles records byte-identical to the per-frame loop's.  Under
        a mesh both stages shard over frames (parallel/batch.py)."""
        payloads: List[bytes] = []
        keyframes = 0
        a0 = arrs[0]
        h, w = a0.shape[:2]
        n = h * w
        dev = self.device
        tables = get_hash_tables(n, "video", dev)
        l_pad = bloom_core.bitmap_pad(n)

        for kind, start, end in _plan_segments(len(arrs),
                                               self.keyframe_interval,
                                               self._chunk):
            if kind == "key":
                payloads.append(fc.encode_keyframe_best(arrs[start],
                                                        infos[start]))
                keyframes += 1
                continue
            real = end - start
            stacked = self._upload(np.stack(arrs[start - 1:end]))
            curr_d = stacked[1:]
            if self.mesh is not None:
                masks_d, packed_d, counts_d = pbatch.make_gop_masks_dp(
                    self.mesh)(stacked[:-1], curr_d)
            else:
                masks_d, packed_d, counts_d = gop_mod.gop_masks(stacked)
            counts = counts_d.cpu().numpy()

            ks = np.zeros(real, np.float64)
            l_arr = np.ones(real, np.int64)
            thi = np.zeros(real, np.int64)
            tlo = np.zeros(real, np.int64)
            fk = np.zeros(real, np.int64)
            bloom_js = []
            for j in range(real):
                p = int(counts[j]) / n
                k, l = optimal_compression_params(n, p)
                ks[j] = k
                if p >= blocked_pipeline.P_STAR or l == 0 or l >= n:
                    continue  # pass-through (witness empty)
                if l >= bloom_core.MAX_MODULUS:
                    raise ValueError(
                        f"filter length {l} exceeds supported maximum")
                bloom_js.append(j)
                l_arr[j] = l
                _, fk[j], (thi[j], tlo[j]) = _filter_scalars(k)

            vmax = min(gop_mod.next_bucket(int(counts.max())),
                       bitpack.padded_length(n))
            encode = (pbatch.make_gop_encode_dp(self.mesh, l_pad=l_pad,
                                                vmax=vmax)
                      if self.mesh is not None else
                      partial(gop_mod.gop_encode, l_pad=l_pad, vmax=vmax))
            out = encode(masks_d, curr_d, tables.h1, tables.h2, tables.act,
                         *(torch.from_numpy(x).to(dev)
                           for x in (l_arr, thi, tlo, fk)))
            pb, pw, wcnt, vals, packed = (
                t.cpu().numpy() for t in (*out, packed_d))

            bloom_set = set(bloom_js)
            for j in range(real):
                cnt = int(counts[j])
                p = cnt / n
                values = vals[j, :cnt].reshape(-1)
                if j in bloom_set:
                    l = int(l_arr[j])
                    wc = int(wcnt[j])
                    rec = fc.build_interframe_record(
                        p, n, ks[j], pb[j][: (l + 7) // 8].tobytes(), l,
                        pw[j][: (wc + 7) // 8].tobytes(), wc, values)
                else:
                    rec = fc.build_interframe_record(
                        p, n, ks[j], packed[j][: (n + 7) // 8].tobytes(),
                        n, b"", 0, values)
                # Encoder freedom: dense masks (scene cuts) fall back to
                # a keyframe when that is not larger (loop-path policy).
                if p > blocked_pipeline.KEY_DENSITY:
                    key = fc.encode_keyframe_best(arrs[start + j],
                                                  infos[start + j])
                    if len(key) <= len(rec):
                        payloads.append(key)
                        keyframes += 1
                        continue
                payloads.append(rec)
        return payloads, keyframes

    def _encode_frames_loop(self, frames) -> tuple[List[bytes], int]:
        """One frame at a time: keyframes where the schedule, a dtype
        other than uint8 or a change of shape demand one, type-0 Bloom
        records between them, diffed against the encoder's own
        reconstruction (so near-lossless mode cannot drift)."""
        payloads: List[bytes] = []
        keyframes = 0
        recon_prev = None  # encoder-side reconstruction state
        recon_info = None
        for i, frame in enumerate(frames):
            arr = np.asarray(unwrap(frame))
            info = yuv_info_of(frame)
            force_key = (
                recon_prev is None
                or i % self.keyframe_interval == 0
                or arr.dtype != np.uint8
                or arr.shape != recon_prev.shape
            )
            if force_key:
                payloads.append(fc.encode_keyframe_best(arr, info))
                keyframes += 1
                recon_prev, recon_info = arr, _copy_info(info)
                continue

            prev_d, arr_d = self._upload(recon_prev), self._upload(arr)
            if self.exact:
                mask_d = diff_ops.diff_mask_exact(prev_d, arr_d)
            else:
                is_color = arr.ndim == 3 and arr.shape[2] > 1
                if is_color and self.use_direct_yuv:
                    gray = arr_d[:, :, 0]
                elif is_color:
                    gray = color_ops.bgr_to_gray(arr_d)
                else:
                    gray = arr_d
                mask_d = diff_ops.diff_mask_thresholded(
                    prev_d, arr_d, self._frame_threshold(gray),
                    use_direct_yuv=self.use_direct_yuv)
            mask = mask_d.cpu().numpy()

            values = diff_ops.gather_changed_values(arr, mask, info)
            inter = fc.encode_interframe(mask, values, self.bloom_compressor)
            # Encoder freedom: fall back to a keyframe when the diff record
            # is not actually smaller (dense masks on scene cuts).
            if float(mask.mean()) > blocked_pipeline.KEY_DENSITY:
                key = fc.encode_keyframe_best(arr, info)
                if len(key) <= len(inter):
                    payloads.append(key)
                    keyframes += 1
                    recon_prev, recon_info = arr, _copy_info(info)
                    continue
            payloads.append(inter)
            if self.exact:
                recon_prev, recon_info = arr, _copy_info(info)
            else:
                recon_info = _copy_info(recon_info)
                recon_prev = diff_ops.apply_diff(recon_prev, mask, values,
                                                 recon_info)
        return payloads, keyframes

    def _encode_planar(self, frames) -> tuple[List[bytes], int, int]:
        """profile="planar": code the Y/U/V plane sequences independently
        at their native subsampled geometry.

        Returns (payloads, keyframes, native_size); ``native_size`` is the
        true raw plane byte count."""
        wrapped = [f if yuv_info_of(f) is not None
                   else add_yuv_info_to_frame(unwrap(f)) for f in frames]
        infos = [yuv_info_of(f) for f in wrapped]
        fmt = infos[0].get("format", "YUV444")
        shapes = [(np.asarray(i["y_plane"]).shape,
                   np.asarray(i["u_plane"]).shape,
                   np.asarray(i["v_plane"]).shape) for i in infos]
        if any(s != shapes[0] for s in shapes):
            raise ValueError("planar profile requires uniform plane "
                             "geometry across frames")
        h, w = shapes[0][0]
        payloads: List[bytes] = []
        counts = []
        keyframes = 0
        native_size = 0
        for plane in ("y_plane", "u_plane", "v_plane"):
            for i in infos:
                dt = np.asarray(i[plane]).dtype
                if dt != np.uint8:
                    raise ValueError(
                        f"planar profile requires uint8 planes, got {dt} "
                        f"for {plane}; use profile='blocked' (byte-domain "
                        f"inter coding) for high-bit-depth frames")
            seq = [np.ascontiguousarray(i[plane], dtype=np.uint8)
                   for i in infos]
            native_size += sum(p.nbytes for p in seq)
            pl, kf = self._encode_frames(seq)
            counts.append(len(pl))
            keyframes += kf
            payloads.extend(pl)
        header = fc.encode_planar_header(fmt, w, h, len(frames), counts)
        return [header] + payloads, keyframes, native_size

    def _decode_planar(self, payloads: List[bytes]) -> List[YUVFrame]:
        """Inverse of :meth:`_encode_planar`: decode each plane stream,
        reassemble YUVFrames (444 view + exact native planes)."""
        hdr = fc.parse_planar_header(payloads[0], offset=1)
        if len(hdr["plane_counts"]) != 3:
            raise ValueError("planar stream must carry 3 planes")
        seqs = []
        pos = 1
        for c in hdr["plane_counts"]:
            if pos + c > len(payloads):
                raise ValueError("planar stream truncated")
            seqs.append(self._decode_payloads(payloads[pos:pos + c],
                                              typed=True))
            pos += c
        frames = []
        for i in range(hdr["frame_count"]):
            y = np.asarray(unwrap(seqs[0][i]))
            u = np.asarray(unwrap(seqs[1][i]))
            v = np.asarray(unwrap(seqs[2][i]))
            ry, rx = y.shape[0] // u.shape[0], y.shape[1] // u.shape[1]
            u444 = np.repeat(np.repeat(u, ry, axis=0), rx, axis=1)
            v444 = np.repeat(np.repeat(v, ry, axis=0), rx, axis=1)
            frames.append(YUVFrame(
                np.stack([y, u444, v444], axis=-1),
                {"format": hdr["format"], "y_plane": y,
                 "u_plane": u, "v_plane": v}))
        return frames

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
        if self.mode == "keyframe":
            payloads = self.compressor.compress_video(frames)
            keyframes = len(frames)
            magic = container.MAGIC_FIXED
        elif self.profile == "planar":
            payloads, keyframes, original_size = self._encode_planar(frames)
            magic = container.MAGIC_BLOOM
        else:
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
            out = []
            for payload in payloads:
                frame, info = fc.decode_keyframe(payload)
                out.append(YUVFrame(frame, info) if info is not None
                           else frame)
            return out

        if payloads and fc.record_type(payloads[0]) == fc.PLANAR:
            return self._decode_planar(payloads)

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
        # records (keyframes, residuals, type-0 Bloom runs) flush first:
        # they need the reconstruction on the host.
        run_pending = None   # finish() -> decoded frames of prior run
        chain_dev = None     # device last frame of that run

        def _flush_runs():
            nonlocal run_pending, chain_dev
            if run_pending is None:
                return
            fin, run_pending, chain_dev = run_pending, None, None
            for frame in fin():
                _advance(frame)

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
            if rtype in (fc.MOTION_HP, fc.TILES, fc.REF_HP,
                         fc.TILES_HP, fc.ZOOM_G, fc.AVG2, fc.ROT_G) and \
                    _inner_type(payloads[i]) not in fc.RESIDUAL_TYPES:
                raise ValueError(
                    "half-pel/tile/multi-ref wrapper on non-residual "
                    "record")
            # dtype/shape are invariant along an inter chain, so the
            # (possibly still-pending) prev is a valid witness for both
            byte_domain = (prev.dtype != np.uint8
                           or (prev.ndim == 3 and prev.shape[2] > 3))
            if _inner_type(payloads[i]) in fc.RESIDUAL_TYPES:
                _flush_runs()
                frame = self._apply_residual_record(
                    payloads[i], rtype, prev, hist, byte_domain)
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
                # type-0 Bloom runs decode through the gop stages on a
                # host base: no device chaining, flush first
                _flush_runs()
                if byte_domain:
                    decoded = [_from_bytes(d, prev) for d in
                               self._decode_inter_run(self._byte_view(prev),
                                                      run)]
                else:
                    decoded = self._decode_inter_run(prev, run)
                for frame in decoded:
                    _advance(frame)
                i = j
                continue
            real = len(run)
            seg = run + [fc.encode_empty_frame()] * (self._chunk - real)
            if chain_dev is not None:
                base_in = chain_dev
            else:
                base_in = self._byte_view(prev) if byte_domain else prev
            last_dev, fin = self._blocked_dec.decode_run_begin(base_in, seg)

            def run_finish(_fin=fin, _real=real, _bd=byte_domain,
                           _like=prev):
                out = _fin()[:_real]
                if _bd:
                    out = [_from_bytes(d, _like) for d in out]
                return out

            _flush_runs()  # pull the prior run while this one computes
            run_pending, chain_dev = run_finish, last_dev
            i = j
        _flush_runs()
        return frames

    def _apply_residual_record(self, payload: bytes, rtype: int,
                               prev: np.ndarray, hist: List[np.ndarray],
                               byte_domain: bool):
        """Reconstruct one host-applied residual record (types 8-20)
        against the running reconstruction ``prev`` and its history.
        ``byte_domain``: the stream inter-codes the byte view, where the
        encoder emits only plain and integer-motion residuals."""
        if byte_domain and rtype in _NOT_BYTE_DOMAIN:
            raise ValueError(f"{_NOT_BYTE_DOMAIN[rtype]} wrapper on "
                             f"byte-domain stream")
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
        # the encoder diffed/rolled the byte view, so the residual
        # applies on the same representation
        base = self._byte_view(prev) if byte_domain else prev
        residual = fc.parse_residual_any(payload, off, base.shape)
        frame = fc.apply_residual(base, residual, dy, dx,
                                  halfpel=rtype == fc.MOTION_HP)
        return _from_bytes(frame, prev) if byte_domain else frame

    @staticmethod
    def _is_legacy_bloom(payload: bytes) -> bool:
        """Type-0 record with a non-empty witness: the BFV2 (non-blocked)
        rational-Bloom layout, decoded through the gop stages."""
        if fc.record_type(payload) != fc.INTERFRAME:
            return False
        witness_bits = struct.unpack_from("<I", payload, 17)[0]
        return witness_bits > 0

    def _decode_inter_run(self, base: np.ndarray, run: List[bytes]):
        """Decode a run of inter-style records: blocked/sparse/empty/
        pass-through records through the blocked decoder, type-0 Bloom
        records through the gop stages.  Mixed runs are segmented."""
        out: List[np.ndarray] = []
        i = 0
        while i < len(run):
            legacy = self._is_legacy_bloom(run[i])
            j = i
            while j < len(run) and self._is_legacy_bloom(run[j]) == legacy:
                j += 1
            seg = run[i:j]
            if legacy:
                frames = self._decode_seg_legacy(base, seg)
            else:
                real = len(seg)
                seg = seg + [fc.encode_empty_frame()] * (self._chunk - real)
                frames = self._blocked_dec.decode_run(base, seg)[:real]
            out.extend(frames)
            base = frames[-1]
            i = j
        return out

    def _decode_seg_legacy(self, base: np.ndarray, run: List[bytes]):
        """Device decode of a run of type-0/empty records following
        ``base``: the gop decode fields (sharded over frames under a
        mesh), the chain, one pull."""
        b = len(run)
        h, w = base.shape[:2]
        n = h * w
        n8 = bitpack.padded_length(n)
        c = 1 if base.ndim == 2 else base.shape[2]
        dev = self.device
        tables = get_hash_tables(n, "video", dev)

        pbm = np.zeros((b, n8 // 8), np.uint8)
        pwit = np.zeros((b, n8 // 8), np.uint8)
        flags = np.zeros(b, np.int32)
        l_arr = np.ones(b, np.int64)
        thi = np.zeros(b, np.int64)
        tlo = np.zeros(b, np.int64)
        # int32, as in the JAX package: a floor(k) past it (a damaged
        # record) raises OverflowError in both
        fk = np.zeros(b, np.int32)
        values_list = [None] * b
        vneed = 1
        for j, payload in enumerate(run):
            if fc.record_type(payload) == fc.EMPTY:
                flags[j] = 1
                continue
            rec = fc.parse_interframe(payload, offset=1)
            if rec["n"] != n:
                raise ValueError("inter-frame length mismatch with geometry")
            values_list[j] = rec["values"]
            vneed = max(vneed, rec["values_count"] // max(1, c))
            bb = rec["bitmap_bytes"]
            pbm[j, : bb.shape[0]] = bb
            if rec["witness_bits"] == 0:
                flags[j] = 1
                l_arr[j] = max(1, rec["bitmap_bits"])
            else:
                wb = rec["witness_bytes"]
                pwit[j, : wb.shape[0]] = wb
                l_arr[j] = rec["bitmap_bits"]
                _, fk[j], (thi[j], tlo[j]) = _filter_scalars(float(rec["k"]))

        vmax = min(gop_mod.next_bucket(vneed), n8)
        vals = np.zeros((b, vmax, c), np.uint8)
        for j, v in enumerate(values_list):
            if v is not None and v.size:
                vals[j, : v.size // c] = v.reshape(-1, c)

        args = [torch.from_numpy(x).to(dev)
                for x in (pbm, pwit, vals, flags)]
        scalars = [torch.from_numpy(x).to(dev) for x in (l_arr, thi, tlo, fk)]
        base_d = self._upload(base)
        if self.mesh is not None:
            masks_d, pix_d = pbatch.make_gop_decode_fields_dp(
                self.mesh, n=n, vmax=vmax)(
                    *args, tables.h1, tables.h2, tables.act, *scalars)
            frames_d = gop_mod.gop_chain(base_d, masks_d, pix_d)
        else:
            frames_d = gop_mod.gop_decode(
                base_d, *args, tables.h1, tables.h2, tables.act, *scalars,
                n=n, vmax=vmax)
        out = frames_d.cpu().numpy()
        return [out[j] for j in range(b)]

    def decompress_video(self, input_path: str = None,
                         output_path: Optional[str] = None,
                         compressed_frames: List[bytes] = None,
                         metadata: Dict = None) -> List[np.ndarray]:
        """Decompress from a .bfvc file or a raw payload list."""
        start = time.time()
        magic = container.MAGIC_FIXED
        if input_path:
            if not os.path.exists(input_path):
                raise FileNotFoundError(input_path)
            magic, compressed_frames = container.read_bfvc(input_path)
        if not compressed_frames:
            raise ValueError("No compressed frames provided")
        frames = self._decode_payloads(compressed_frames,
                                       typed=(magic == container.MAGIC_BLOOM))
        if output_path:
            low = output_path.lower()
            if low.endswith(".yuv"):
                # byte-exact raw planar export (native planes)
                videoio.write_raw_yuv(output_path, frames)
            elif low.endswith(".y4m"):
                infos = [yuv_info_of(f) for f in frames]
                if any(i is None for i in infos):
                    raise ValueError(
                        "y4m export requires YUV frames — compress with "
                        "--color-space YUV (the default for .y4m/.yuv "
                        "inputs) to round-trip back to Y4M")
                fmt = infos[0].get("format", "444")
                cs = {"I420": "420jpeg", "YV12": "420jpeg",
                      "YUV422": "422", "YUV444": "444"}.get(fmt, fmt)
                h, w = np.asarray(infos[0]["y_plane"]).shape
                videoio.write_y4m(
                    output_path,
                    [(np.asarray(i["y_plane"]), np.asarray(i["u_plane"]),
                      np.asarray(i["v_plane"])) for i in infos],
                    w, h, colorspace=cs)
            else:
                self.save_frames_as_video(frames, output_path)
        if self.verbose:
            dt = time.time() - start
            print(f"Decompressed {len(frames)} frames in {dt:.2f} seconds")
            if dt > 0:
                print(f"Frames Per Second: {len(frames) / dt:.2f}")
        return frames

    # -- verification & I/O -------------------------------------------------

    def verify_lossless(self, original_frames, decompressed_frames) -> Dict:
        return verify_lossless(original_frames, decompressed_frames,
                               self.verbose)

    def add_yuv_info_to_frame(self, yuv_frame):
        return add_yuv_info_to_frame(yuv_frame)

    def _convert(self, op, arr) -> np.ndarray:
        """One ``ops/color.py`` conversion of a host uint8 frame on this
        compressor's device, back as a host array."""
        return op(self._upload(arr)).cpu().numpy()

    def save_frames_as_video(self, frames, output_path: str,
                             fps: int = 30) -> str:
        """Preview export via cv2 (mp4v — not lossless; verification
        always compares in-memory frames)."""
        if not frames:
            raise ValueError("No frames provided")
        first = unwrap(frames[0])
        is_color = first.ndim > 2
        out = []
        for frame in frames:
            arr = unwrap(frame)
            if is_color and yuv_info_of(frame) is not None:
                # YUV content is self-identifying (yuv_info); convert
                # for the BGR writer regardless of the use_direct_yuv
                # flag so YUV-compressed streams export with correct
                # colors.
                arr = self._convert(color_ops.yuv_to_bgr, arr)
            elif not is_color and arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, axis=-1)
            elif is_color and arr.shape[2] == 3 and yuv_info_of(frame) is None:
                arr = arr[..., ::-1]  # RGB -> BGR for the writer
            out.append(arr)
        return videoio.write_video_frames(out, output_path, fps=fps,
                                          is_color=True)

    def analyze_noise_vs_compression(self, width: int = 640,
                                     height: int = 480,
                                     frame_count: int = 90,
                                     noise_levels=None,
                                     output_dir: Optional[str] = None,
                                     color_space: str = "BGR") -> Dict:
        """Sweep synthetic noise levels and measure compression ratio and
        losslessness at each.  Writes a matplotlib plot when output_dir
        is given and the lib is present."""
        from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
            generate_frames,
        )
        if noise_levels is None:
            noise_levels = [0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0]
        ratios, lossless_flags = [], []
        import tempfile
        for noise in noise_levels:
            frames = generate_frames(frame_count, width, height,
                                     noise=noise, color_space=color_space)
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "clip.bfvc")
                res = self.compress_video(frames, path,
                                          input_color_space=color_space)
                rec = self.decompress_video(path)
            v = verify_lossless(frames, rec)
            ratios.append(res["compression_ratio"])
            lossless_flags.append(bool(v["lossless"]))
            if self.verbose:
                print(f"noise={noise}: ratio={res['compression_ratio']:.4f} "
                      f"lossless={v['lossless']}")
        result = {"noise_levels": list(noise_levels), "ratios": ratios,
                  "lossless": lossless_flags, "color_space": color_space}
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                fig, ax = plt.subplots(figsize=(7, 4.5))
                ax.plot(noise_levels, ratios, marker="o")
                ax.set_xlabel("noise level (sigma)")
                ax.set_ylabel("compression ratio")
                ax.set_title(f"Noise vs compression ({color_space})")
                ax.grid(True, alpha=0.3)
                path = os.path.join(
                    output_dir, f"noise_comparison_{color_space}.png")
                fig.savefig(path, dpi=110)
                plt.close(fig)
                result["plot"] = path
            except ImportError:
                pass
        return result

    def extract_frames_from_video(self, video_path: str, max_frames: int = 0,
                                  target_fps: Optional[float] = None,
                                  scale_factor: float = 1.0,
                                  output_color_space: Optional[str] = None,
                                  width: Optional[int] = None,
                                  height: Optional[int] = None,
                                  format: str = "I420",
                                  frame_step: int = 1) -> List[np.ndarray]:
        """Extract frames from a file.

        ``output_color_space=None`` picks :func:`default_color_space` for
        the file: YUV for native-YUV containers (.y4m) — the lossless
        native-plane path — else BGR.  A single ``.exr`` or a directory
        of them gives float frames (``utils/exr.py``).  Raw ``.yuv``
        files need width/height (and format/frame_step)."""
        if output_color_space is None:
            output_color_space = default_color_space(video_path)
        if video_path.lower().endswith(".exr") or (
                os.path.isdir(video_path) and any(
                    f.lower().endswith(".exr")
                    for f in os.listdir(video_path))):
            from new_bloom_filter_repo_tpu_torch.utils import exr
            if os.path.isdir(video_path):
                paths = sorted(
                    os.path.join(video_path, f)
                    for f in os.listdir(video_path)
                    if f.lower().endswith(".exr"))
                if max_frames:
                    paths = paths[:max_frames]
                return [exr.read_exr(p) for p in paths]
            return [exr.read_exr(video_path)]
        if video_path.lower().endswith(".yuv") or (width and height):
            if not (width and height):
                raise ValueError("raw YUV input requires width and height")
            frames = videoio.read_raw_yuv(video_path, width, height, format,
                                          max_frames, frame_step)
            return [add_yuv_info_to_frame(f) for f in frames]
        if video_path.lower().endswith(".y4m"):
            frames, params = videoio.read_y4m(video_path, max_frames)
            if output_color_space.upper() == "YUV":
                # Carry the file's ORIGINAL subsampled planes so the
                # planar profile can code (and export) them exactly.
                out = []
                for f, planes in zip(frames, params["planes"]):
                    if len(planes) == 3 and f.ndim == 3:
                        out.append(YUVFrame(f, {
                            "format": params["colorspace"],
                            "y_plane": planes[0].copy(),
                            "u_plane": planes[1].copy(),
                            "v_plane": planes[2].copy()}))
                    else:
                        out.append(add_yuv_info_to_frame(f)
                                   if f.ndim == 3 else f)
                return out
            bgr = [self._convert(color_ops.yuv_to_bgr, f) for f in frames]
            if output_color_space.upper() == "RGB":
                return [f[..., ::-1] for f in bgr]
            return bgr
        frames = videoio.open_video_frames(video_path, max_frames,
                                           target_fps, scale_factor)
        cs = output_color_space.upper()
        if cs == "RGB":
            return [f[..., ::-1] for f in frames]
        if cs == "YUV":
            return [add_yuv_info_to_frame(
                self._convert(color_ops.bgr_to_yuv, f)) for f in frames]
        return frames


def _from_bytes(fb: np.ndarray, like: np.ndarray) -> np.ndarray:
    """A decoded byte view back as a frame of ``like``'s dtype and
    shape."""
    return (np.ascontiguousarray(fb).reshape(-1).view(like.dtype)
            .reshape(like.shape))


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
