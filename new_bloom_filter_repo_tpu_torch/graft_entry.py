"""Single-step entry point and multi-device dry runs.

The counterpart of the repository's ``__graft_entry__.py`` for the
PyTorch port:

* :func:`entry` returns the rational-Bloom frame encode step (insert
  pass, membership pass, witness compaction; ``ops/bloom_core``) and
  example arguments;
* :func:`dryrun_multichip` runs one sharded batch encode + decode step
  of ``parallel/batch.py`` on a mesh (frames over ``dp``, the index axis
  over ``sp``, bit-array partials OR-reduced, witness segments placed by
  an exclusive scan of the per-shard counts), requires the round trip to
  be exact, then runs :func:`dryrun_blocked_dp`;
* :func:`dryrun_blocked_dp` runs the frame-sharded K5a encode and the
  frame-sharded K5b + K4 decode and requires the decoded change mask to
  equal the encoded bits.

Unlike the JAX package, nothing here probes backends or falls back to
virtual CPU devices: a mesh is built from the devices it names, and
:func:`auto_mesh` raises when there are too few cards.  After
``parallel.mesh.initialize_distributed`` the blocked dry run also runs
on a mesh over several processes (each runs its own cells and receives
the others' outputs); the BFV2 dry run stays within one process, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
    _filter_scalars,
)
from new_bloom_filter_repo_tpu_torch.models.bloom import (
    optimal_compression_params,
)
from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.ops import bloom_core
from new_bloom_filter_repo_tpu_torch.ops.hashtables import get_hash_tables
from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch
from new_bloom_filter_repo_tpu_torch.parallel import blocked_batch
from new_bloom_filter_repo_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    default_device,
)


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


def _filter_batch(bits: np.ndarray):
    """Per-row (l, t_hi, t_lo, floor_k) of a (B, n) bit batch, l >= 1."""
    n = bits.shape[1]
    rows = []
    for row in bits:
        k, l = optimal_compression_params(n, row.sum() / n)
        _, floor_k, (t_hi, t_lo) = _filter_scalars(k)
        rows.append((max(1, l), int(t_hi), int(t_lo), floor_k))
    return [np.array(col, np.int64) for col in zip(*rows)]


def entry(device=None):
    """(fn, example_args): the single-frame Bloom encode step, n = 4096
    items at 10 % density, with the example on ``device`` (default: the
    current CUDA card; without a card, pass ``device="cpu"``)."""
    dev = default_device(device)
    n = 4096
    l_pad = bloom_core.bitmap_pad(n)
    k_max = bloom_core.MAX_LANES

    def step(bits, h1hi, h1lo, h2hi, h2lo, ahi, alo, l, t_hi, t_lo, floor_k):
        h1, h2, act = (h1hi, h1lo), (h2hi, h2lo), (ahi, alo)
        bit_array = bloom_core.insert_partial_lanes(
            bits, h1, h2, act, l, t_hi, t_lo, floor_k, k_max, l_pad)
        pass_mask = bloom_core.membership_lanes(
            bit_array, h1, h2, act, l, t_hi, t_lo, floor_k, k_max)
        witness, count = bloom_core.witness_compact(bits, pass_mask)
        return bit_array, witness, count

    rng = np.random.default_rng(0)
    bits = (rng.random((1, n)) < 0.1).astype(np.uint8)
    t = get_hash_tables(n, "video", dev)
    scalars = [torch.tensor(int(x[0]), device=dev)
               for x in _filter_batch(bits)]
    example_args = (torch.from_numpy(bits[0]).to(dev),
                    *t.h1, *t.h2, *t.act, *scalars)
    return step, example_args


def dryrun_multichip(mesh_or_n) -> dict:
    """One sharded batch encode + decode step over a mesh, then the
    blocked dry run on the same mesh.

    ``mesh_or_n``: a :class:`Mesh`, or a device count n for
    ``auto_mesh(n, sp=2 if n is even else 1)`` over distinct CUDA cards
    (which raises when the machine has fewer).  Runs 2 * dp frames of
    n = 512 * sp items at densities 3-28 %; raises unless the decode
    equals the bits.  Returns the inputs and outputs of the BFV2 step
    (tensors on the mesh's home device)."""
    if isinstance(mesh_or_n, Mesh):
        mesh = mesh_or_n
    else:
        n_dev = int(mesh_or_n)
        mesh = auto_mesh(n_dev, sp=2 if n_dev % 2 == 0 else 1)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    home = mesh.home
    n = 512 * sp
    batch = 2 * dp
    l_pad = bloom_core.bitmap_pad(n)

    rng = np.random.default_rng(0)
    densities = [0.03 + 0.25 * i / max(1, batch - 1) for i in range(batch)]
    bits_np = np.stack([(rng.random(n) < d).astype(np.uint8)
                        for d in densities])
    scalars = tuple(torch.from_numpy(x).to(home)
                    for x in _filter_batch(bits_np))
    t = get_hash_tables(n, "video", home)
    tables = (*t.h1, *t.h2, *t.act)
    bits = torch.from_numpy(bits_np).to(home)
    encoded = pbatch.make_sharded_encode(mesh, n, l_pad)(bits, tables,
                                                         *scalars)
    decoded = pbatch.make_sharded_decode(mesh, n, l_pad)(
        encoded[0], encoded[1], tables, *scalars)
    if not torch.equal(decoded, bits):
        raise AssertionError("multichip dry-run round trip mismatch")
    print(f"dryrun_multichip OK: mesh dp={dp} sp={sp}, batch={batch}, n={n}")
    dryrun_blocked_dp(mesh)
    return {"bits": bits, "tables": tables, "scalars": scalars,
            "encoded": encoded, "decoded": decoded}
