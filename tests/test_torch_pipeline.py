"""The PyTorch port's blocked pipeline against the JAX package's.

Hash tables, phase A (diff masks, per-block counts, packed pixels, the
global-motion search and its shift gate), the per-tile motion summary,
and whole chunks through the encoder and decoder.  Inputs are seeded
numpy clips handed to both packages; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from new_bloom_filter_repo_tpu.models import blocked_pipeline as jbp
from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as tbp
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.ops import hashtables as tht
from new_bloom_filter_repo_tpu_torch.utils import container
from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
    SUITE,
    generate_frames,
)


def clip(name, f=8, w=64, h=48, gray=False, seed=0):
    frames = generate_frames(f, w, h, seed=seed, **SUITE[name])
    if gray:
        frames = [np.ascontiguousarray(x[..., 0]) for x in frames]
    return frames


def n(x):
    return np.asarray(x)


def tied_clip():
    """A clip whose motion search ties: every column pattern repeats
    with period 4, and the scene moves 2 px right, so dx = -6, -2, 2
    and 6 all match exactly (dy = 0).  The gate must take the first
    minimum in (dy, dx) order, dx = -6."""
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 256, (48, 4, 3), dtype=np.uint8)
    prev = np.tile(cols, (1, 16, 1))
    prev[:, :, 1] = rng.integers(0, 256, (48, 1), dtype=np.uint8)
    return [prev, np.roll(prev, 2, axis=1)]


@pytest.mark.parametrize("npix", [64 * 48, 8192, 96 * 80, 20000])
def test_tables_match_jax(npix):
    jt = jbp.blocked_tables(npix)
    tt = tht.blocked_tables(npix, "cpu")
    assert (tt["nb"], tt["npad"]) == (jt["nb"], jt["npad"])
    assert tt["npad"] % tht.SUPER == 0 and tt["npad"] >= npix
    nb = jt["nb"]
    for k in ("h1", "h2", "act_hi", "act_lo"):
        assert tt[k].dtype == torch.int32 and tuple(tt[k].shape) == (
            nb, tht.IPB)
        np.testing.assert_array_equal(
            n(tt[k]), n(jt[k])[:nb].view(np.int32))
    carried = tht.tables_from_numpy({k: n(v) if hasattr(v, "shape") else v
                                     for k, v in jt.items()})
    assert (carried["nb"], carried["npad"]) == (nb, jt["npad"])
    for k in ("h1", "h2", "act_hi", "act_lo"):
        assert carried[k].dtype == torch.int32
        assert torch.equal(carried[k], tt[k])


PHASE_A_CLIPS = {
    "pan_rgb": lambda: clip("pan"),
    "static_rgb": lambda: clip("static_gentle"),
    "pan_gray": lambda: clip("pan", w=96, h=80, gray=True),
    "scene_cuts_rgb": lambda: clip("scene_cuts", f=14),
    "tied": tied_clip,
}


@pytest.mark.parametrize("name", sorted(PHASE_A_CLIPS))
def test_phase_a_matches_jax(name):
    frames = PHASE_A_CLIPS[name]()
    stacked = np.stack(frames)
    h, w = frames[0].shape[:2]
    npad = tht.npad_of(h * w)
    nb = npad // tht.IPB
    stride = jbp.motion_stride(h, w)
    assert stride == tbp.motion_stride(h, w)
    want = [n(x) for x in jbp._phase_a_auto(jnp.asarray(stacked),
                                            stride=stride, npad=npad, nb=nb)]
    st = torch.from_numpy(stacked)
    got = [n(x) for x in tbp._phase_a_auto(st, stride=stride, npad=npad,
                                           nb=nb)]
    for g, w_ in zip(got, want):       # masks, counts, vals, shifts, best
        assert g.shape == w_.shape and g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)
    np.testing.assert_array_equal(
        n(tbp._motion_counts_pair(st[:-1], st[1:], stride=stride)),
        n(jbp._motion_counts(jnp.asarray(stacked), stride=stride)))
    for g, w_ in zip(tbp._phase_a(st, npad=npad, nb=nb),
                     jbp._phase_a(jnp.asarray(stacked), npad=npad, nb=nb)):
        np.testing.assert_array_equal(n(g), n(w_))
    np.testing.assert_array_equal(
        n(tbp._phase_a_packed(st, npad=npad)),
        n(jbp._phase_a_packed(jnp.asarray(stacked), npad=npad)))
    shifts = want[3].copy()
    np.testing.assert_array_equal(
        n(tbp._phase_a_packed_motion(st, torch.from_numpy(shifts),
                                     npad=npad)),
        n(jbp._phase_a_packed_motion(jnp.asarray(stacked),
                                     jnp.asarray(shifts), npad=npad)))
    if name == "tied":
        np.testing.assert_array_equal(got[4], [[0, -6]])
        np.testing.assert_array_equal(got[3], [[0, -6]])
    if name.startswith("pan"):
        assert got[3].any()           # the pan was found


@pytest.mark.parametrize("name", ["pan", "zoom"])
def test_tile_motion_best_matches_jax(name):
    frames = clip(name, f=4, w=96, h=80)
    stacked = np.stack(frames)
    h, w = frames[0].shape[:2]
    tlog, stride = jbp.tile_log(h, w), jbp.motion_stride(h, w)
    want = n(jbp._tile_motion_best(jnp.asarray(stacked), tlog=tlog,
                                   stride=stride))
    got = n(tbp._tile_motion_best(torch.from_numpy(stacked), tlog=tlog,
                                  stride=stride))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pack_helpers_round_trip():
    rng = np.random.default_rng(2)
    for shape in [(7, 9, 3), (7, 9, 2), (7, 9)]:
        base = rng.integers(0, 256, shape, dtype=np.uint8)
        packed = tbp._pack_base(torch.from_numpy(base), npad=8192, nb=8)
        np.testing.assert_array_equal(
            n(packed), n(jbp._pack_base(jnp.asarray(base), npad=8192,
                                        nb=8)))
        frames = tbp._unpack_frames(packed[None], shape=shape)
        np.testing.assert_array_equal(n(frames)[0], base)
        c = 1 if len(shape) == 2 else shape[2]
        vb = tbp._pack_vseg_bytes(packed[None], c)
        np.testing.assert_array_equal(
            n(vb), n(jbp._pack_vseg_bytes(jnp.asarray(n(packed))[None], c)))
        np.testing.assert_array_equal(
            n(tbp._unpack_vseg_bytes(vb, c)), n(packed)[None])


CHUNK_CLIPS = {
    "pan_rgb": lambda: clip("pan", f=9),
    "static_gray": lambda: clip("static_gentle", f=9, w=96, h=80,
                                gray=True),
    "scene_cuts_rgb": lambda: clip("scene_cuts", f=14),
    "film_grain_rgb": lambda: clip("film_grain", f=6),
}


@pytest.mark.parametrize("name", sorted(CHUNK_CLIPS))
def test_chunk_payloads_match_jax(name):
    frames = CHUNK_CLIPS[name]()
    base, chunk = frames[0], frames[1:]

    def keyframe_fn(j):      # scene-cut fallback, host bytes only
        return fc.encode_keyframe_best(chunk[j], None, zlib_level=6)

    want, want_kf = jbp.BlockedEncoder().encode_chunk_begin(
        base, chunk, keyframe_fn)()
    got, got_kf = tbp.BlockedEncoder(device="cpu").encode_chunk_begin(
        base, chunk, keyframe_fn)()
    assert got_kf == want_kf
    assert len(got) == len(want) == len(chunk)
    for j, (g, w_) in enumerate(zip(got, want)):
        assert g == w_, f"{name}: record {j} differs"


def test_chunk_decoders_agree_with_each_other():
    """A device-decodable run (motion-wrapped blocked records and an
    empty record) decodes to the source frames through either package's
    run decoder, the port's chaining on its device-resident last
    frame."""
    frames = clip("pan", f=9)
    frames.insert(5, frames[4].copy())            # an EMPTY record
    base, chunk = frames[0], frames[1:]
    payloads, kf = tbp.BlockedEncoder(device="cpu").encode_chunk_begin(
        base, chunk)()
    assert kf == 0
    assert {fc.record_type(p) for p in payloads} == {fc.MOTION, fc.EMPTY}
    dec = tbp.BlockedDecoder(device="cpu")
    last, fin = dec.decode_run_begin(base, payloads[:4])
    assert torch.is_tensor(last)
    first = fin()
    rest = dec.decode_run(last, payloads[4:])
    for got, src in zip(first + rest, chunk):
        np.testing.assert_array_equal(got, src)
    for got, src in zip(jbp.BlockedDecoder().decode_run(base, payloads),
                        chunk):
        np.testing.assert_array_equal(n(got), src)


def test_decoder_rejects_out_of_range_m():
    """A blocked record whose sub-filter width lies outside [16, 384]
    is refused, as the reference decoder refuses it."""
    npix = 64 * 48
    nb = tht.npad_of(npix) // tht.IPB
    rec = fc.build_interframe_record(
        0.01, npix, 2.0, b"\xff" * nb, 8 * nb, b"\x00", 1,
        np.zeros(0, np.uint8))
    bad = bytes([fc.BLOCKED]) + rec[1:]
    base = np.zeros((48, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="sub-filter width 8"):
        tbp.BlockedDecoder(device="cpu").decode_run(base, [bad])


# ---------------------------------------------------------------------------
# The serial and one-device forms: choose_shifts, _motion_counts,
# _phase_a_motion, encode_chunk, NBF_OVERLAP=0
# ---------------------------------------------------------------------------

def _policy_counts():
    """The reference's shift-policy cases: a clear winner at (2, -1), a
    best that barely beats the zero shift, a zero count too small to be
    worth a shift."""
    side = 2 * tbp.MOTION_RADIUS + 1
    zero = tbp.MOTION_RADIUS * side + tbp.MOTION_RADIUS
    win = (tbp.MOTION_RADIUS + 2) * side + (tbp.MOTION_RADIUS - 1)
    counts = np.full((3, side * side), 1000, np.int64)
    counts[0, win] = 100
    counts[1, zero] = 500
    counts[1, win] = 450
    counts[2, :] = 10
    counts[2, win] = 0
    return counts


def _seeded_counts():
    rng = np.random.default_rng(9)
    side = 2 * tbp.MOTION_RADIUS + 1
    counts = rng.integers(0, 400, (40, side * side)).astype(np.int32)
    counts[::3, rng.integers(0, side * side, 14)] = 0     # exact matches
    counts[5] = 7                                         # every shift ties
    return counts


@pytest.mark.parametrize("make", [_policy_counts, _seeded_counts],
                         ids=["policy", "seeded"])
def test_choose_shifts_matches_jax(make):
    counts = make()
    got = tbp.choose_shifts(counts)
    assert got.dtype == np.int32 and got.shape == (counts.shape[0], 2)
    np.testing.assert_array_equal(got, jbp.choose_shifts(counts))
    if make is _policy_counts:
        assert got.tolist() == [[2, -1], [0, 0], [0, 0]]


@pytest.mark.parametrize("name", ["pan_rgb", "pan_gray", "tied"])
def test_motion_counts_and_phase_a_motion_match_jax(name):
    """The one-device forms of what ``_MeshDispatch.motion_counts`` and
    ``.phase_a_motion`` shard, and the two-step shift decision they give
    with ``choose_shifts``: equal to the fused phase A's."""
    frames = PHASE_A_CLIPS[name]()
    stacked = np.stack(frames)
    h, w = frames[0].shape[:2]
    npad = tht.npad_of(h * w)
    nb = npad // tht.IPB
    stride = tbp.motion_stride(h, w)
    st = torch.from_numpy(stacked)
    counts = tbp._motion_counts(st, stride=stride)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(
        n(counts), n(jbp._motion_counts(jnp.asarray(stacked), stride=stride)))
    shifts = tbp.choose_shifts(n(counts))
    fused = tbp._phase_a_auto(st, stride=stride, npad=npad, nb=nb)
    np.testing.assert_array_equal(shifts, n(fused[3]))
    got = tbp._phase_a_motion(st, torch.from_numpy(shifts), npad=npad, nb=nb)
    want = jbp._phase_a_motion(jnp.asarray(stacked), jnp.asarray(shifts),
                               npad=npad, nb=nb)
    for g, w_, f_ in zip(got, want, fused):
        assert n(g).dtype == n(w_).dtype
        np.testing.assert_array_equal(n(g), n(w_))
        np.testing.assert_array_equal(n(g), n(f_))
    zero = tbp._phase_a_motion(st, torch.zeros((len(frames) - 1, 2),
                                               dtype=torch.int32),
                               npad=npad, nb=nb)
    for g, w_ in zip(zero, tbp._phase_a(st, npad=npad, nb=nb)):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("name", ["pan_rgb", "scene_cuts_rgb"])
def test_encode_chunk_matches_begin_and_jax(name):
    frames = CHUNK_CLIPS[name]()
    base, chunk = frames[0], frames[1:]

    def keyframe_fn(j):
        return fc.encode_keyframe_best(chunk[j], None, zlib_level=6)

    sink = [b"kept"]
    times = {}
    kf = tbp.BlockedEncoder(device="cpu").encode_chunk(
        base, chunk, sink, keyframe_fn, stage_times=times)
    begin, begin_kf = tbp.BlockedEncoder(device="cpu").encode_chunk_begin(
        base, chunk, keyframe_fn)()
    want = []
    want_kf = jbp.BlockedEncoder().encode_chunk(base, chunk, want,
                                                keyframe_fn)
    assert sink[0] == b"kept" and sink[1:] == begin == want
    assert kf == begin_kf == want_kf
    assert "enc_device_phase_a" in times and "enc_assembly" in times


@pytest.mark.parametrize("interval, keys", [(6, 3), (4, 4)])
def test_overlap_off_writes_the_same_bytes(tmp_path, monkeypatch, interval,
                                           keys):
    """``NBF_OVERLAP=0`` (every job inline) against the default schedule
    (the finish worker, and a keyframe pool two threads wide, fewer than
    the clip's scheduled keyframes) and against the JAX package, on 13
    frames with scheduled keyframes in the middle and chunks of two; the
    schedule counter."""
    from new_bloom_filter_repo_tpu.models.video import (
        ImprovedVideoCompressor as JaxCompressor)
    from new_bloom_filter_repo_tpu_torch.models import video

    monkeypatch.setattr(video.os, "cpu_count", lambda: 8)
    plan = video._plan_segments(13, interval, 2)
    assert sum(kind == "key" for kind, _, _ in plan) == keys
    assert video.keyframe_pool_width(keys) == 2
    frames = clip("pan", f=13)
    blobs, counts = {}, {}
    for overlap in ("1", "0"):
        monkeypatch.setenv("NBF_OVERLAP", overlap)
        path = str(tmp_path / f"o{overlap}.bfvc")
        comp = video.ImprovedVideoCompressor(
            device="cpu", keyframe_interval=interval, batch_size=2)
        video.reset_keyframe_schedule_counts()
        comp.compress_video(frames, path, input_color_space="BGR")
        counts[overlap] = video.keyframe_schedule_counts()
        with open(path, "rb") as fh:
            blobs[overlap] = fh.read()
        for got, src in zip(comp.decompress_video(path), frames):
            np.testing.assert_array_equal(np.asarray(got), src)
    monkeypatch.setenv("NBF_OVERLAP", "0")
    path = str(tmp_path / "jax.bfvc")
    JaxCompressor(keyframe_interval=interval, batch_size=2).compress_video(
        frames, path, input_color_space="BGR")
    with open(path, "rb") as fh:
        blobs["jax"] = fh.read()
    assert blobs["0"] == blobs["1"] == blobs["jax"]
    on = counts["1"]
    assert on["scheduled"] == keys == on["ready"] + on["waited"]
    assert counts["0"] == {"scheduled": 0, "ready": 0, "waited": 0}
    records = [fc.record_type(p) for p in
               container.read_bfvc(str(tmp_path / "o0.bfvc"))[1]]
    assert len(records) == 13 and fc.MOTION in records


@pytest.mark.parametrize("where", ["keyframe", "finish"])
def test_a_failed_job_raises_out_of_compress(tmp_path, monkeypatch, where):
    """The second scheduled keyframe (on the keyframe pool) or the second
    chunk's ``finish()`` raises: ``compress_video`` raises that error
    within its time limit, and no worker thread outlives the call."""
    import signal
    import threading

    from new_bloom_filter_repo_tpu_torch.models import video

    class Planted(Exception):
        pass

    calls = []
    lock = threading.Lock()

    def failing(real, on_thread):
        def wrapped(*args, **kwargs):
            if threading.current_thread().name.startswith(on_thread):
                with lock:
                    calls.append(1)
                    nth = len(calls)
                if nth == 2:
                    raise Planted(where)
            return real(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(video.os, "cpu_count", lambda: 8)
    if where == "keyframe":
        monkeypatch.setattr(fc, "encode_keyframe_best", failing(
            fc.encode_keyframe_best, "nbf-keyframe"))
    else:
        monkeypatch.setattr(tbp, "finish_chunk", failing(
            tbp.finish_chunk, "nbf-finish"))
    comp = video.ImprovedVideoCompressor(device="cpu", keyframe_interval=4,
                                         batch_size=2)

    def expire(signum, frame):
        raise TimeoutError("compress_video did not end within 60 s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(60)
    try:
        with pytest.raises(Planted, match=where):
            comp.compress_video(clip("pan", f=13), str(tmp_path / "x.bfvc"),
                                input_color_space="BGR")
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert len(calls) >= 2
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("nbf-keyframe", "nbf-finish"))]


# ---------------------------------------------------------------------------
# The encoder's host phase: the prediction table and repeated host phases
# ---------------------------------------------------------------------------

def _searched_tags():
    """The tags the candidate search puts into its ``cands`` list, read
    from the module's source."""
    import ast
    import inspect

    tags = set()
    for node in ast.walk(ast.parse(inspect.getsource(tbp))):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "append" and getattr(
                node.func.value, "id", None) == "cands":
            tags.add(node.args[0].elts[0].value)
        elif isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "cands":
            tags |= {e.elts[0].value for e in node.value.elts}
    return tags


# (tag, meta, inner residual type, record type of the wrapped record)
WRAPS = [
    ("int", (0, 0), fc.RESIDUAL, fc.RESIDUAL),
    ("int", (0, 0), fc.RESIDUAL_S, fc.RESIDUAL_S),
    ("int", (0, 0), fc.RESIDUAL_F, fc.RESIDUAL_F),
    ("int", (2, -1), fc.RESIDUAL, fc.MOTION),
    ("hp", (1, -3), fc.RESIDUAL, fc.MOTION_HP),
    ("ref", (2, 3, -1), fc.RESIDUAL_S, fc.REF_HP),
    ("avg2", (2, 16), fc.RESIDUAL_F, fc.AVG2),
    ("tile", np.array([[[1, 0], [0, -2], [0, 0]], [[-1, 1], [2, 0], [0, 1]]],
                      np.int8), fc.RESIDUAL, fc.TILES),
    ("tileh", np.array([[[1, 0], [0, -3], [0, 0]], [[-1, 1], [2, 0],
                                                    [0, 1]]], np.int8),
     fc.RESIDUAL, fc.TILES_HP),
    ("zoomg", (2, 30000, 10000, 1, -1), fc.RESIDUAL, fc.ZOOM_G),
    ("rotg", (2, 40000, 15000, 0, 1), fc.RESIDUAL, fc.ROT_G),
]


def test_prediction_table_covers_the_candidate_search():
    assert _searched_tags() == set(tbp.PREDICTIONS) == {w[0] for w in WRAPS}


@pytest.mark.parametrize("tag,meta,inner,rtype", WRAPS,
                         ids=[f"{w[0]}-{w[2]}-{w[3]}" for w in WRAPS])
def test_prediction_wraps_to_its_record_type_and_decodes(tag, meta, inner,
                                                         rtype):
    """Each table entry's wrapped residual record has its record type,
    and the decoder rebuilds the frame from it: the prediction and the
    wrapper say the same thing."""
    import zlib

    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    rng = np.random.default_rng(7)
    hist = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
            for _ in range(2)]
    curr = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    pred = tbp.PREDICTIONS[tag].predict(lambda rb: hist[-rb], meta,
                                        tbp.TILE_LOG)
    raw = (curr - pred).tobytes()
    if inner == fc.RESIDUAL:
        rec = fc.build_residual_record(len(raw), zlib.compress(raw))
    elif inner == fc.RESIDUAL_S:
        rec = fc.build_residual_s_record((0, raw, 0))
    else:
        plane = np.frombuffer(raw, np.uint8).reshape(curr.shape)
        rec = fc.build_residual_f_record(
            2, (0, fc.spatial_filter(plane, 2).tobytes(), 0))
    wrapped = tbp.PREDICTIONS[tag].wrap(meta, rec, tbp.TILE_LOG)
    assert fc.record_type(wrapped) == rtype
    got = ImprovedVideoCompressor(device="cpu")._apply_residual_record(
        wrapped, rtype, hist[-1], hist, False)
    np.testing.assert_array_equal(got, curr)


def test_host_phase_runs_again_to_the_same_bytes():
    """Each chunk's host phase, run again after the next chunk's, gives
    the same records: the zoom and rotation trackers start every run of
    a chunk from its entry snapshot.  The clip rotates, so the first
    chunk's type-20 trials advance the rotation tracker."""
    from test_torch_video import rotation

    frames = rotation(9, 128, 96)
    enc = tbp.BlockedEncoder(device="cpu")
    key = lambda c: (lambda j: fc.encode_keyframe_best(c[j], None))  # noqa
    fins = [enc.encode_chunk_begin(frames[0], frames[1:5],
                                   key(frames[1:5])),
            enc.encode_chunk_begin(frames[4], frames[5:], key(frames[5:]))]
    first = [fin() for fin in fins]
    assert [fin() for fin in fins] == first
    assert [fins[1](), fins[0]()] == first[::-1]
    assert fc.ROT_G in {fc.record_type(p) for p in first[0][0]}
