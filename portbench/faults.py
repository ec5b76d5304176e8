"""Faults planted in the program underneath the timed calls, to show
that the comparison with the reference catches each kind a cell can
have.  Used by ``tests/test_portbench_run.py`` on the CPU and by
``control.py`` on the card at a cell's own size.

- ``hold_state``: a decode run returns its base frame for every frame
  and chains on it, and a residual record applied on the host returns
  the previous frame: a step that leaves its state unchanged.
- ``drop_half``: the encoder writes "no change" records in place of
  every other frame's record of a chunk: half of the batch left out.
- ``drop_records``: the container writer stores half of the records.
- ``skip_keys``: only frame 0 is a scheduled keyframe, whatever the
  configured interval (smaller and faster, but no random access).
- ``alter``: one byte of one decoded frame is changed where the decoder
  produces it; in a planar file, one byte of each plane sequence's
  middle frame, as each sequence is decoded.

A cell runs on one card, so there is no exchange between cards to
leave out.  The control (the near-lossless ``exact=False`` path) is not
a fault: it is the program's own lower-precision option, set by
``control.py`` through the configuration.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("hold_state", "drop_half", "drop_records", "skip_keys", "alter")


@contextlib.contextmanager
def planted(name: str):
    """Patch the program with fault ``name`` for the life of the
    block."""
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
    from new_bloom_filter_repo_tpu_torch.models import video
    from new_bloom_filter_repo_tpu_torch.utils import container

    extra = []
    if name == "hold_state":
        target, attr = bp.BlockedDecoder, "decode_run_begin"
        orig = target.decode_run_begin

        def new(self, base, payloads, stage_times=None):
            _, fin = orig(self, base, payloads, stage_times=stage_times)

            def finish():
                out = fin()
                held = np.asarray(base.cpu() if hasattr(base, "cpu")
                                  else base).reshape(out[0].shape)
                return [held.copy() for _ in out]
            return base, finish

        target2 = video.ImprovedVideoCompressor
        orig2 = target2._apply_residual_record

        def held_residual(self, payload, rtype, prev, hist, byte_domain):
            orig2(self, payload, rtype, prev, hist, byte_domain)
            return np.array(prev)

        extra = [(target2, "_apply_residual_record", held_residual)]
    elif name == "drop_half":
        target, attr = bp.BlockedEncoder, "encode_chunk_begin"
        orig = target.encode_chunk_begin

        def new(self, base, frames, keyframe_fn=None, **kw):
            fin = orig(self, base, frames, keyframe_fn, **kw)

            def finish():
                payloads, keys = fin()
                return ([p if j % 2 == 0 else fc.encode_empty_frame()
                         for j, p in enumerate(payloads)], keys)
            return finish
    elif name == "drop_records":
        target, attr = container, "write_bfvc"
        orig = container.write_bfvc

        def new(path, payloads, magic=container.MAGIC_FIXED):
            return orig(path, payloads[:len(payloads) // 2], magic)
    elif name == "skip_keys":
        target, attr = video, "_plan_segments"
        orig = video._plan_segments

        def new(total, keyframe_interval, chunk=video._CHUNK):
            return orig(total, total + 1, chunk)
    elif name == "alter":
        target, attr = video.ImprovedVideoCompressor, "_decode_payloads"
        orig = target._decode_payloads

        def new(self, payloads, typed):
            out = orig(self, payloads, typed)
            k = len(out) // 2
            if not isinstance(out[k], np.ndarray):
                return out  # a planar file's frames, altered in their planes
            frame = np.array(out[k])
            frame.reshape(-1)[frame.size // 2] ^= 1
            out[k] = frame
            return out
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    patches = [(target, attr, new)] + extra
    origs = [(t, a, getattr(t, a)) for t, a, _ in patches]
    for t, a, fn in patches:
        setattr(t, a, fn)
    try:
        yield
    finally:
        for t, a, fn in origs:
            setattr(t, a, fn)
