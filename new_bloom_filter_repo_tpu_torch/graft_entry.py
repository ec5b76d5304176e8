"""Multi-device dry run of the blocked kernels.

The counterpart of the repository's ``__graft_entry__.py`` for the
PyTorch port.  :func:`dryrun_blocked_dp` runs the frame-sharded K5a
encode and the frame-sharded K5b + K4 decode on a mesh and requires the
decoded change mask to equal the encoded bits, as the JAX dry run does.

Not ported yet, and raising ``NotImplementedError``: :func:`entry` and
the BFV2 half of :func:`dryrun_multichip`, which run ``ops/bloom_core``
and ``parallel/batch.py`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.parallel import blocked_batch
from new_bloom_filter_repo_tpu_torch.parallel.mesh import Mesh


def dryrun_inputs(f: int, nb: int, seed: int = 1):
    """The dry run's seeded K5a inputs (bits, a, b, act, vals, m,
    floor_k) as numpy arrays: 5 % change density, a and b below m = 100,
    activation density 0.4, floor(k) = 2."""
    rng = np.random.default_rng(seed)
    shape = (f, nb, bk.IPB)
    bits = (rng.random(shape) < 0.05).astype(np.uint8)
    a = rng.integers(0, 100, shape).astype(np.int32)
    b = rng.integers(0, 100, shape).astype(np.int32)
    act = (rng.random(shape) < 0.4).astype(np.uint8)
    vals = rng.integers(0, 1 << 24, shape).astype(np.int32)
    return (bits, a, b, act, vals, np.full(f, 100, np.int32),
            np.full(f, 2, np.int32))


def dryrun_blocked_dp(mesh: Mesh, *, nb: int = 8, seed: int = 1) -> dict:
    """Frame-sharded step of the blocked kernels: 2 * dp frames of ``nb``
    blocks, K5a encode under ``make_blocked_encode_dp``, then K5b + K4
    decode under ``make_blocked_decode_dp``; raises unless the decoded
    mask equals the bits.  Returns the inputs and both programs'
    outputs (tensors on the mesh's home device) for further checks."""
    dp = mesh.shape["dp"]
    f = 2 * dp
    home = mesh.home
    args = tuple(torch.from_numpy(x).to(home)
                 for x in dryrun_inputs(f, nb, seed))
    enc = blocked_batch.make_blocked_encode_dp(mesh, k_lanes=2, vh=4)
    encoded = enc(*args)
    words, wit, _, vseg, _ = encoded
    dec = blocked_batch.make_blocked_decode_dp(mesh, k_lanes=2, vh=4)
    flags = torch.zeros(f, dtype=torch.int32, device=home)
    decoded = dec(words, args[1], args[2], args[3], args[5], args[6], flags,
                  wit, torch.zeros_like(args[0]), vseg)
    if not torch.equal(decoded[2], args[0]):
        raise AssertionError("blocked dp dry-run round trip mismatch")
    print(f"dryrun_multichip blocked-dp OK: frames={f} over dp={dp}")
    return {"args": args, "flags": flags, "encoded": encoded,
            "decoded": decoded}


def entry():
    """The BFV2 single-step entry point: not ported yet."""
    raise NotImplementedError(
        "entry() runs the BFV2 cores (ops/bloom_core), not ported to the "
        "PyTorch package yet (ROADMAP Queue 1 item 10)")


def dryrun_multichip(n_devices: int):
    """The BFV2 multi-device dry run: not ported yet."""
    raise NotImplementedError(
        "dryrun_multichip runs the BFV2 sharded cores (parallel/batch.py), "
        "not ported to the PyTorch package yet (ROADMAP Queue 1 item 10); "
        "dryrun_blocked_dp runs the blocked half")
