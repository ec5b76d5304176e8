"""Damaged ``.bfvc`` streams: the port decodes them as the JAX package does.

The JAX package's contract (tests/test_robustness.py): a corrupted
stream raises, or decodes to frames; it never crashes, hangs or returns
frames the stream does not determine.  Here each trial damages the same
bytes of a stream the JAX package wrote, decodes them in both packages
and holds the port to the JAX package: both raise (the exception's
class may differ), or both return frames equal bit for bit.  One
package raising where the other returns frames fails the trial, and so
does a decode that runs past its time limit: each port decode runs
under its own ``SIGALRM``, so a hang fails its test instead of running
the suite out of time.

The port runs on the CPU, through its kernels' plain twins; the JAX
package runs as its own tests run it (Pallas in interpret mode).  The
damage comes from numpy seeds; the tests marked ``slow`` mirror the
JAX package's slow tests, with the same seeds and trial counts.
"""

import contextlib
import signal
import struct
import zlib

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu.models.video import (
    ImprovedVideoCompressor as JaxCompressor,
)
from new_bloom_filter_repo_tpu.ops.pallas import blocked as jbk
from new_bloom_filter_repo_tpu.utils.streaminfo import attribute_stream
from new_bloom_filter_repo_tpu.utils.synthetic import SUITE, generate_frames
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.models.blocked_pipeline import npad_of
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.ops import blocked as tbk
from new_bloom_filter_repo_tpu_torch.ops import bloom_core
from new_bloom_filter_repo_tpu_torch.ops.bitpack import padded_length
from new_bloom_filter_repo_tpu_torch.parallel.mesh import make_mesh
from new_bloom_filter_repo_tpu_torch.utils import container
from test_robustness import make_stream
from test_torch_kernels import make_inputs, t

PORT_SECONDS = 30       # a port decode of these small streams takes < 1 s
JAX_SECONDS = 120       # the JAX package probes 33 lanes at k = 2e6 in ~8 s


class Hung(BaseException):
    """A decode ran past its time limit.  A BaseException, so that no
    ``except Exception`` inside a decoder can swallow it."""


@contextlib.contextmanager
def time_limit(seconds: int, what: str):
    def expire(signum, frame):
        raise Hung(f"{what} did not finish within {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def outcome(decompress, path: str, seconds: int, what: str):
    """("frames", [arrays]) or ("raise", the exception)."""
    with time_limit(seconds, what):
        try:
            frames = decompress(path)
        except Exception as exc:          # the contract allows any class
            return "raise", exc
    return "frames", [np.asarray(f) for f in frames]


def describe(out) -> str:
    if out[0] == "raise":
        return f"raised {type(out[1]).__name__}: {out[1]}"
    return f"returned {len(out[1])} frames"


def assert_same(jax_out, port_out, label: str) -> None:
    if jax_out[0] != port_out[0]:
        pytest.fail(f"{label}: JAX {describe(jax_out)}, port "
                    f"{describe(port_out)}")
    if jax_out[0] == "raise":
        return
    jf, tf = jax_out[1], port_out[1]
    assert len(jf) == len(tf), label
    for i, (a, b) in enumerate(zip(jf, tf)):
        assert a.shape == b.shape and a.dtype == b.dtype, (label, i)
        if a.tobytes() != b.tobytes():
            pytest.fail(f"{label}: frame {i} differs in "
                        f"{int((a != b).sum())} values")


def decode_both(tmp_path, blob: bytes, label: str, devices=None):
    """Decode ``blob`` in both packages; fail unless they agree.
    Returns the JAX package's outcome."""
    path = str(tmp_path / "damaged.bfvc")
    with open(path, "wb") as f:
        f.write(blob)
    jax_out = outcome(JaxCompressor(verbose=False).decompress_video, path,
                      JAX_SECONDS, f"the JAX decode of {label}")
    port = ImprovedVideoCompressor(verbose=False, device="cpu",
                                   devices=devices)
    port_out = outcome(port.decompress_video, path, PORT_SECONDS,
                       f"the port's decode of {label}")
    assert_same(jax_out, port_out, label)
    return jax_out


def flip_trials(blob: bytes, seed: int, trials: int):
    """The JAX tests' recipe: three random bytes past the container
    header XORed with a random non-zero byte, per trial."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        bad = bytearray(blob)
        for _ in range(3):
            pos = int(rng.integers(16, len(bad)))
            bad[pos] ^= int(rng.integers(1, 256))
        yield trial, bytes(bad)


def edit_record(blob: bytes, index: int, offset: int, new: bytes) -> bytes:
    """``blob`` with record ``index``'s bytes at ``offset`` replaced."""
    magic, payloads = container.parse_bfvc(blob)
    rec = bytearray(payloads[index])
    rec[offset:offset + len(new)] = new
    payloads[index] = bytes(rec)
    return container.serialize_bfvc(payloads, magic)


def first_record(blob: bytes, *types) -> int:
    """Index of the first record whose type byte is in ``types``."""
    _, payloads = container.parse_bfvc(blob)
    return next(i for i, p in enumerate(payloads)
                if fc.record_type(p) in types)


def clip(name, f=6, w=64, h=48, **kw):
    return generate_frames(f, w, h, seed=0, **SUITE[name], **kw)


def sparse_clip(f=6):
    rng = np.random.default_rng(3)
    frames = [clip("static_gentle", 1)[0]]
    for _ in range(f - 1):
        x = frames[-1].copy()
        x[rng.integers(0, 48, 2), rng.integers(0, 64, 2)] ^= 9
        frames.append(x)
    return frames


# Streams the JAX package writes (the port writes the same bytes:
# tests/test_torch_video.py), each built once for the module.
STREAMS = {
    # blocked type-7 records after a keyframe
    "static": lambda: (clip("static_gentle"), {}),
    # type-6 (global motion) records wrapping type 7
    "pan": lambda: (clip("pan"), {}),
    # type-0 Bloom records (the gop stages)
    "bfv2": lambda: (clip("static_gentle"), {"profile": "bfv2"}),
    # type-0 Bloom records of the near-lossless mode
    "lossy": lambda: (clip("static_gentle"), {"exact": False}),
    # three plane streams after a type-5 header
    "planar": lambda: (generate_frames(5, 64, 48, noise=2.0, seed=3,
                                       color_space="YUV"),
                       {"profile": "planar", "use_direct_yuv": True}),
    # sparse change records (4): two pixels change a frame
    "sparse": lambda: (sparse_clip(), {}),
    # half-pel (9), multi-reference (16) and half-pel tile (17) records
    "pan_subpixel": lambda: (generate_frames(10, 256, 192, noise=0.5,
                                             seed=5, pan=0.6,
                                             pan_mode="subpixel"),
                             {"keyframe_interval": 10}),
    # parametric zoom records (18)
    "zoom": lambda: (generate_frames(8, 128, 96, noise=1.0, seed=5,
                                     zoom=0.002), {"keyframe_interval": 8}),
}


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    cache = {}

    def get(name: str) -> bytes:
        if name not in cache:
            frames, kw = STREAMS[name]()
            kw.setdefault("keyframe_interval", 30)
            path = str(tmp_path_factory.mktemp(name) / "ok.bfvc")
            JaxCompressor(verbose=False, **kw).compress_video(
                frames, path,
                input_color_space="YUV" if kw.get("use_direct_yuv")
                else "BGR")
            with open(path, "rb") as f:
                cache[name] = f.read()
        return cache[name]

    return get


# ---------------------------------------------------------------------------
# The lane count: floor(k) of a blocked record sets how many lanes K2
# probes.  The JAX package caps them at 32 (k_bucket); without the cap a
# damaged k of 40.5 decoded other frames and 2e6 never finished.
# ---------------------------------------------------------------------------

# where k sits in each stream's first inter record
K_FIELD = {"static": 9,           # type 7: <B 7, <f p, <I n, <f k
           "pan": 5 + 9}          # type 6: <B 6, <hh dy dx, then type 7


@pytest.mark.parametrize("k", [40.5, 2e6])
@pytest.mark.parametrize("name", sorted(K_FIELD))
def test_damaged_k_decodes_as_jax(tmp_path, stream, name, k):
    blob = stream(name)
    idx = first_record(blob, fc.BLOCKED_Z, fc.MOTION)
    bad = edit_record(blob, idx, K_FIELD[name], struct.pack("<f", k))
    jax_out = decode_both(tmp_path, bad, f"{name}, k = {k}")
    assert jax_out[0] == "frames"      # both decode 33 lanes, not 41 / 2e6


def test_damaged_k_decodes_as_jax_on_a_cpu_mesh(tmp_path, stream):
    blob = stream("static")
    idx = first_record(blob, fc.BLOCKED_Z)
    bad = edit_record(blob, idx, K_FIELD["static"], struct.pack("<f", 2e6))
    mesh = make_mesh(2, 1, ["cpu", "cpu"])
    jax_out = decode_both(tmp_path, bad, "static on a (2, 1) mesh, k = 2e6",
                          devices=mesh)
    assert jax_out[0] == "frames"


def test_lane_count_is_the_jax_cap():
    assert tbk.MAX_K_LANES == jbk.k_bucket(10 ** 9) == 32
    for fk in (-5, 0, 1, 12, 24, 25, 32, 33, 40, 2_000_000):
        want = min(max(fk, 0), 32)
        assert tbk.lane_count(fk) == want
        # the JAX bucket covers the same lanes (extra lanes are gated off)
        assert jbk.k_bucket(fk) >= want


LANE_WRAPPERS = {
    "K1": lambda a, k: tbk.blocked_encode_h(*a, k_lanes=k, vh=4, nw=12),
    "K2": lambda a, k: tbk.blocked_membership_h(
        torch.zeros(a[0].shape[:2] + (12,), dtype=torch.int32), *a[1:5],
        *a[6:], torch.zeros(a[0].shape[0], dtype=torch.int32), k_lanes=k),
    "K5a": lambda a, k: tbk.blocked_encode(
        a[0], a[1].expand(a[0].shape), a[2].expand(a[0].shape),
        a[0], a[5], a[6], a[9], k_lanes=k, vh=4, nw=12),
    "K5b": lambda a, k: tbk.blocked_membership(
        torch.zeros(a[0].shape[:2] + (12,), dtype=torch.int32),
        a[1].expand(a[0].shape), a[2].expand(a[0].shape), a[0], a[6], a[9],
        torch.zeros(a[0].shape[0], dtype=torch.int32), k_lanes=k),
}


@pytest.mark.parametrize("kernel", sorted(LANE_WRAPPERS))
def test_wrappers_refuse_lane_counts_past_the_cap(kernel):
    bits, tab, vals, m, fk, thi, tlo = make_inputs(
        2, 2, [64, 64], [3, 40], [0.01, 0.01], "random", seed=1)
    args = (t(bits), t(tab["h1"]), t(tab["h2"]), t(tab["act_hi"]),
            t(tab["act_lo"]), t(vals), t(m), t(thi), t(tlo), t(fk))
    for bad in (33, 2_000_000, -1):
        with pytest.raises(ValueError, match="k_lanes"):
            LANE_WRAPPERS[kernel](args, bad)
    LANE_WRAPPERS[kernel](args, 32)


def test_32_lanes_match_pallas():
    """K2 at k_lanes = 32 on frames whose floor(k) is 40, 33 and 20
    equals the Pallas kernel at the bucket the JAX decoder takes."""
    bits, tab, vals, m, fk, thi, tlo = make_inputs(
        3, 8, [384, 100, 64], [40, 33, 20], [0.004, 0.002, 0.01], "random",
        seed=3)
    k = tbk.lane_count(int(fk.max()))
    assert k == jbk.k_bucket(int(fk.max())) == 32
    targs = (t(bits), t(tab["h1"]), t(tab["h2"]), t(tab["act_hi"]),
             t(tab["act_lo"]), t(vals), t(m), t(thi), t(tlo), t(fk))
    words = tbk.blocked_encode_h(*targs, k_lanes=k, vh=4, nw=12)[0]
    flags = np.array([0, 0, 1], np.int32)
    jp, jc = jbk.blocked_membership_h(
        words.numpy(), tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"], m,
        thi, tlo, fk, flags, k_lanes=k, nw=12)
    tp, tc = tbk.blocked_membership_h(words, *targs[1:5], *targs[6:],
                                      t(flags), k_lanes=k, nw=12)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.sum()) > 0


# ---------------------------------------------------------------------------
# The JAX decoder's padded blocks: from nb = 512 on it runs K2 and the
# witness and value slicing over nbk_of(nb) blocks, nb rounded up to a
# multiple of 64, whose sub-filter words and hash tables are zero.  A
# frame with no active lane (k = 0 exactly, or floor(k) < 0) passes every
# item of those blocks too, so the JAX package wants 128 witness bytes
# more a padded block.
# ---------------------------------------------------------------------------

PAD_H, PAD_W = 520, 1024              # nb = 520, nbk = 576


@pytest.fixture(scope="module")
def padded_stream(tmp_path_factory):
    """A port-written stream at PAD_H x PAD_W: a keyframe, then two type-7
    records."""
    frames = generate_frames(3, PAD_W, PAD_H, seed=0,
                             **SUITE["static_gentle"])
    path = str(tmp_path_factory.mktemp("padded") / "ok.bfvc")
    ImprovedVideoCompressor(verbose=False, device="cpu").compress_video(
        frames, path)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("rows", ["nb", "nbk"])
def test_k_zero_at_a_padded_geometry_decodes_as_jax(tmp_path, padded_stream,
                                                     rows):
    """The first inter record's k set to 0 and its witness section
    rebuilt raw to exactly ``rows`` x 128 bytes, seeded bits that need no
    more values than the record holds: with nb rows the JAX package finds
    the witness short (it also reads the padded blocks) and raises, with
    nbk rows both return the same frames."""
    from new_bloom_filter_repo_tpu.models.blocked_pipeline import nbk_of

    nb = npad_of(PAD_H * PAD_W) // tbk.IPB
    nbk = nbk_of(nb)
    assert (nb, nbk) == (520, 576)
    magic, payloads = container.parse_bfvc(padded_stream)
    idx = first_record(padded_stream, fc.BLOCKED_Z)
    rec = fc.parse_blocked_z(payloads[idx], 1)
    n_rows = nb if rows == "nb" else nbk
    rng = np.random.default_rng(11)
    bits = np.zeros(nbk * tbk.IPB, np.uint8)
    bits[rng.choice(bits.size, rec["values_count"] // 3,
                    replace=False)] = 1
    wit = np.packbits(bits)[: n_rows * tbk.WIT_BYTES].tobytes()
    payloads[idx] = fc.build_blocked_z_record(
        rec["p"], rec["n"], 0.0, rec["bitmap_bits"], n_rows * tbk.IPB,
        (0, rec["bitmap_bytes"].tobytes(), 0), (0, wit, 0),
        zlib.compress(rec["values"].tobytes()), rec["values_count"])
    jax_out = decode_both(tmp_path, container.serialize_bfvc(payloads, magic),
                          f"k = 0, witness of {rows} rows")
    assert jax_out[0] == ("raise" if rows == "nb" else "frames")


def test_padded_block_counts_are_the_jax_decoders(padded_stream):
    """The port's witness counts of a parsed chunk, padded blocks
    included, equal the JAX decoder's, with k edited to 0, -5 and 0.5 (a
    lane is active there, so the padded blocks stay closed)."""
    from new_bloom_filter_repo_tpu.models.blocked_pipeline import (
        BlockedDecoder as JaxDecoder)
    from new_bloom_filter_repo_tpu_torch.models.blocked_pipeline import (
        BlockedDecoder)

    _, payloads = container.parse_bfvc(padded_stream)
    shape = (PAD_H, PAD_W, 3)
    for k in (0.0, -5.0, 0.5):
        run = [payloads[1][:9] + F32(k) + payloads[1][13:], payloads[2]]
        jdec = JaxDecoder()
        _, want = jdec.membership_counts(jdec.parse_records(shape, run),
                                         shape)
        tdec = BlockedDecoder(device="cpu")
        _, got = tdec.membership_counts(tdec.parse_records(shape, run),
                                        shape)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert int(got[0, 520:].sum()) == (56 * 1024 if k <= 0 else 0)


# ---------------------------------------------------------------------------
# The audit: every value a record sets that reaches a loop count, an
# allocation, an index, a shift or a kernel's geometry on the decode
# path, edited in place.  (stream, record type, offset in the record,
# new bytes.)
# ---------------------------------------------------------------------------

U32 = struct.Struct("<I").pack
F32 = struct.Struct("<f").pack
I16x2 = struct.Struct("<hh").pack
I16 = struct.Struct("<h").pack
N = 64 * 48                           # items of the 64x48 streams
NB = npad_of(N) // tbk.IPB            # their blocks

AUDIT = {
    # parse_records: the blocked record's k, n, m and sections
    "blocked k = -5": ("static", fc.BLOCKED_Z, 9, F32(-5.0)),
    "blocked k = 3e9": ("static", fc.BLOCKED_Z, 9, F32(3e9)),
    "blocked k = nan": ("static", fc.BLOCKED_Z, 9, F32(float("nan"))),
    "blocked k = 0": ("static", fc.BLOCKED_Z, 9, F32(0.0)),
    "blocked n + 1": ("static", fc.BLOCKED_Z, 5, U32(N + 1)),
    "blocked bitmap_bits 0": ("static", fc.BLOCKED_Z, 13, U32(0)),
    "blocked bitmap_bits 2^32-1": ("static", fc.BLOCKED_Z, 13,
                                   U32(0xFFFFFFFF)),
    "blocked bitmap_bits m = 385": ("static", fc.BLOCKED_Z, 13,
                                    U32(385 * NB)),
    "blocked bitmap_bits m = 16": ("static", fc.BLOCKED_Z, 13,
                                   U32(16 * NB)),
    "blocked witness_bits 0": ("static", fc.BLOCKED_Z, 17, U32(0)),
    "blocked witness_bits 2^32-1": ("static", fc.BLOCKED_Z, 17,
                                    U32(0xFFFFFFFF)),
    "blocked bitmap coding 9": ("static", fc.BLOCKED_Z, 21, b"\x09"),
    "blocked bitmap length 2^31": ("static", fc.BLOCKED_Z, 22, U32(1 << 31)),
    "blocked bitmap raw length 1": ("static", fc.BLOCKED_Z, 26, U32(1)),
    # slice_streams: the sections' bytes against wcnt, vh and the values
    "blocked section bytes 40-47 zeroed": ("static", fc.BLOCKED_Z, 40,
                                           b"\x00" * 8),
    # _chain_apply_motion: the type-6 shifts
    "motion shift +32767": ("pan", fc.MOTION, 1, I16x2(32767, 32767)),
    "motion shift -32768": ("pan", fc.MOTION, 1, I16x2(-32768, -32767)),
    "motion shift (h, -w)": ("pan", fc.MOTION, 1, I16x2(48, -64)),
    "motion k = 2e6, shift -1": ("pan", fc.MOTION, 1,
                                 I16x2(-1, 0) + b"\x07" + F32(0.5)
                                 + U32(N) + F32(2e6)),
    # sparse records: n, the index count, the value count
    "sparse n + 1": ("sparse", fc.SPARSE, 1, U32(N + 1)),
    "sparse index count 0": ("sparse", fc.SPARSE, 5, U32(0)),
    "sparse index count 2^32-1": ("sparse", fc.SPARSE, 5, U32(0xFFFFFFFF)),
    # the gop stages (bfv2 and near-lossless type-0 records): l, k
    "type-0 bitmap_bits 0": ("bfv2", fc.INTERFRAME, 13, U32(0)),
    "type-0 bitmap_bits n8 + 1": ("bfv2", fc.INTERFRAME, 13,
                                  U32(padded_length(N) + 1)),
    "type-0 bitmap_bits 2^28": ("bfv2", fc.INTERFRAME, 13, U32(1 << 28)),
    "type-0 bitmap_bits 2^32-1": ("bfv2", fc.INTERFRAME, 13,
                                  U32(0xFFFFFFFF)),
    "type-0 k = 2e6": ("bfv2", fc.INTERFRAME, 9, F32(2e6)),
    "type-0 k = 3e9": ("bfv2", fc.INTERFRAME, 9, F32(3e9)),
    "type-0 k = -3": ("bfv2", fc.INTERFRAME, 9, F32(-3.0)),
    "type-0 values_count 2^32-1": ("bfv2", None, None, None),
    "lossy bitmap_bits 2^31": ("lossy", fc.INTERFRAME, 13, U32(1 << 31)),
    "lossy k = 40.5": ("lossy", fc.INTERFRAME, 9, F32(40.5)),
    # planar: the type-5 header's record count of the first plane
    "planar plane count 2^32-1": ("planar", fc.PLANAR, None, None),
    # the keyframe records
    # (type 15: <B 15, <B filter, <B flag, <III h w itemsize)
    "keyframe height 2^16": ("static", fc.KEYFRAME_S, 3, U32(1 << 16)),
    "keyframe width 0": ("static", fc.KEYFRAME_S, 7, U32(0)),
    # the half-pel (9), multi-reference (16) and tile (17) wrappers
    "half-pel shift +32767": ("pan_subpixel", fc.MOTION_HP, 1,
                              I16x2(32767, -32768)),
    "multi-ref back 15": ("pan_subpixel", fc.REF_HP, 1, b"\x0f"),
    "multi-ref shift -32768": ("pan_subpixel", fc.REF_HP, 2,
                               I16x2(-32768, 32767)),
    "tiles log 12": ("pan_subpixel", fc.TILES_HP, 1, b"\x0c"),
    "tiles count 1 x 1": ("pan_subpixel", fc.TILES_HP, 2,
                          b"\x01\x00\x01\x00"),
    # the zoom wrapper (18)
    "zoom back 15": ("zoom", fc.ZOOM_G, 1, b"\x0f"),
    "zoom scale 500000": ("zoom", fc.ZOOM_G, 2, struct.pack("<i", 500000)),
    "zoom shift +32767": ("zoom", fc.ZOOM_G, 10, I16x2(32767, 32767)),
}


def audit_blob(stream, name: str) -> bytes:
    which, rtype, offset, new = AUDIT[name]
    blob = stream(which)
    if name == "type-0 values_count 2^32-1":
        # the u32 after the witness section: find it from the sizes
        idx = first_record(blob, fc.INTERFRAME)
        rec = container.parse_bfvc(blob)[1][idx]
        bsize = struct.unpack_from("<I", rec, 21)[0]
        wsize = struct.unpack_from("<I", rec, 25 + bsize)[0]
        return edit_record(blob, idx, 29 + bsize + wsize + 4,
                           U32(0xFFFFFFFF))
    if name == "planar plane count 2^32-1":
        idx = first_record(blob, fc.PLANAR)
        rec = container.parse_bfvc(blob)[1][idx]
        hdr = fc.parse_planar_header(rec, offset=1)
        # <B 5, <H len + format, <I width, <I height, <I frame_count,
        # <B n_planes, n_planes x <I records
        at = 1 + 2 + len(hdr["format"].encode()) + 13
        assert rec[at:at + 4] == U32(hdr["plane_counts"][0])
        return edit_record(blob, idx, at, U32(0xFFFFFFFF))
    idx = first_record(blob, rtype)
    return edit_record(blob, idx, offset, new)


@pytest.mark.parametrize("name", sorted(AUDIT))
def test_audited_field_decodes_as_jax(tmp_path, stream, name):
    decode_both(tmp_path, audit_blob(stream, name), name)


# Values the sweep writes at every offset: u32 extremes and sizes, f32
# k values (the lane cap's edges, NaN, infinity, a subnormal), i16 shift
# extremes.
SWEEP_VALUES = (
    [U32(v) for v in (0, 1, 0xFFFFFFFF, 0x7FFFFFFF, 1 << 28, 1 << 31, 5000,
                      100000)]
    + [F32(v) for v in (40.5, 2e6, -5.0, 0.0, float("nan"), float("inf"),
                        1e-30, 32.9, 33.0, 12.5, 0.5, 3e9)]
    + [I16(v) for v in (32767, -32768, -32767, 48, -64, 1)])
SWEEP_BYTES = 40


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.slow
def test_field_sweep_decodes_as_jax(tmp_path, stream, name):
    """The audit at large: each value of SWEEP_VALUES written at each of
    the first 40 bytes of the first record of every kind (type, and the
    inner type behind a type-6 header) in the stream."""
    blob = stream(name)
    _, payloads = container.parse_bfvc(blob)
    kinds = {}
    for i, p in enumerate(payloads):
        inner = p[5] if fc.record_type(p) == fc.MOTION and len(p) > 5 else 0
        kinds.setdefault((fc.record_type(p), inner), i)
    for (rtype, inner), idx in sorted(kinds.items()):
        size = len(payloads[idx])
        for at in range(1, min(SWEEP_BYTES, size)):
            for new in SWEEP_VALUES:
                if at + len(new) <= size:
                    decode_both(tmp_path, edit_record(blob, idx, at, new),
                                f"{name} record {idx} (type {rtype}/{inner})"
                                f" byte {at} = {new.hex()}")


def test_decode_core_refuses_lanes_past_the_cap():
    """The binary codec's decode_core runs floor(k) + 1 lanes; the JAX
    package unrolls them when it compiles, so a damaged k of 2e6 never
    finishes there.  The port raises instead (ROADMAP Queue 3)."""
    n = 256
    bits = torch.zeros(n, dtype=torch.uint8)
    halves = (torch.zeros(n, dtype=torch.int64),) * 2
    for fk in (bloom_core.MAX_LANES + 1, 2_000_000):
        with pytest.raises(ValueError, match="lanes"):
            bloom_core.decode_core(bits, bits, halves, halves, halves, 64, 0,
                                   0, floor_k=fk)
    out = bloom_core.decode_core(bits, bits, halves, halves, halves, 64, 0,
                                 0, floor_k=bloom_core.MAX_LANES)
    assert out.shape == (n,)


def test_decode_core_matches_jax_at_the_cap_and_below_zero():
    """Within the cap, decode_core equals the JAX package's: at 13 lanes,
    and at a negative floor(k), where lane 0 runs under the activation
    test."""
    from new_bloom_filter_repo_tpu.ops import bloom_core as jcore
    from new_bloom_filter_repo_tpu.ops.hashtables import (
        get_hash_tables as jax_tables)
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
        get_hash_tables)

    n, l = 256, 200
    rng = np.random.default_rng(5)
    bits = (rng.random(bloom_core.bitmap_pad(n)) < 0.6).astype(np.uint8)
    wit = rng.integers(0, 2, n).astype(np.uint8)
    jt, tt = jax_tables(n), get_hash_tables(n, "video", "cpu")
    for fk, thi, tlo in ((-3, 0x40000000, 0), (13, 0x80000000, 5)):
        want = np.asarray(jcore.decode_core(
            bits, wit, jt.h1, jt.h2, jt.act, np.uint32(l), np.uint32(thi),
            np.uint32(tlo), floor_k=fk))
        got = bloom_core.decode_core(
            torch.from_numpy(bits), torch.from_numpy(wit), tt.h1, tt.h2,
            tt.act, l, thi, tlo, floor_k=fk)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# A targeted header fuzz: one seeded XOR at each of the first 30 bytes of
# the first inter record of a static and a pan stream.
# ---------------------------------------------------------------------------

HEADER_BYTES = 30


@pytest.mark.parametrize("byte", range(HEADER_BYTES))
@pytest.mark.parametrize("name", ["static", "pan"])
def test_inter_record_header_fuzz(tmp_path, stream, name, byte):
    blob = stream(name)
    idx = first_record(blob, fc.BLOCKED_Z, fc.MOTION)
    rec = container.parse_bfvc(blob)[1][idx]
    xor = int(np.random.default_rng([7, byte]).integers(1, 256))
    bad = edit_record(blob, idx, byte, bytes([rec[byte] ^ xor]))
    decode_both(tmp_path, bad, f"{name}, byte {byte} ^ {xor:#04x}")


# ---------------------------------------------------------------------------
# The mirror of tests/test_robustness.py, with its streams, seeds and
# trial counts; a not-slow subset of its random fuzz.
# ---------------------------------------------------------------------------

PROFILES = [("blocked", "BGR"), ("bfv2", "BGR"), ("planar", "YUV")]


def profile_stream(tmp_path, profile, cs) -> bytes:
    return make_stream(tmp_path, profile=profile, color_space=cs,
                       use_direct_yuv=(cs == "YUV"))[1]


@pytest.mark.slow
def test_truncations_raise_in_both(tmp_path):
    _, blob = make_stream(tmp_path)
    for cut in (3, 7, 9, len(blob) // 3, len(blob) - 2):
        jax_out = decode_both(tmp_path, blob[:cut], f"cut at {cut}")
        assert jax_out[0] == "raise"


@pytest.mark.parametrize("profile,cs", PROFILES)
@pytest.mark.slow
def test_random_byte_corruption_decodes_as_jax(tmp_path, profile, cs):
    blob = profile_stream(tmp_path, profile, cs)
    for trial, bad in flip_trials(blob, seed=0, trials=12):
        decode_both(tmp_path, bad, f"{profile} trial {trial}")


@pytest.mark.parametrize("profile,cs", PROFILES)
def test_random_byte_corruption_subset_decodes_as_jax(tmp_path, profile,
                                                      cs):
    blob = profile_stream(tmp_path, profile, cs)
    for trial, bad in flip_trials(blob, seed=0, trials=4):
        decode_both(tmp_path, bad, f"{profile} trial {trial}")


@pytest.mark.parametrize("kind,need", [("pan_subpixel",
                                        "motion-tiles-halfpel"),
                                       ("zoom", "motion-zoom")])
@pytest.mark.slow
def test_motion_wrapped_corruption_decodes_as_jax(tmp_path, stream, kind,
                                                  need):
    blob = stream(kind)
    _, payloads = container.parse_bfvc(blob)
    kinds = set(attribute_stream(payloads)["records"])
    assert need in kinds, f"stream lacks {need}: {kinds}"
    for trial, bad in flip_trials(blob, seed=1, trials=12):
        decode_both(tmp_path, bad, f"{kind} trial {trial}")


def test_unknown_record_type_raises_in_both(tmp_path):
    blob = container.serialize_bfvc([b"\x1fweird"], container.MAGIC_BLOOM)
    jax_out = decode_both(tmp_path, blob, "unknown type")
    assert jax_out[0] == "raise"
    assert "Unknown frame type" in str(jax_out[1])


def test_interframe_before_keyframe_raises_in_both(tmp_path):
    blob = container.serialize_bfvc([b"\x02"], container.MAGIC_BLOOM)
    jax_out = decode_both(tmp_path, blob, "inter record first")
    assert jax_out[0] == "raise"
    assert "before any keyframe" in str(jax_out[1])


def test_a_hung_decode_fails_its_trial(tmp_path):
    """The time limit itself: a decode that does not return fails the
    trial with the limit's message, whatever the decoder catches."""
    def hangs(path):
        try:
            while True:
                pass
        except Exception:                 # must not swallow the limit
            return []

    with pytest.raises(Hung, match="within 1 s"):
        outcome(hangs, str(tmp_path / "x"), 1, "a decode that hangs")
