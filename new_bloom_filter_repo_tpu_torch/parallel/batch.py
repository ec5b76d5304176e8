"""Sharded BFV2 batch encode/decode steps over a (dp, sp) mesh.

The port of ``new_bloom_filter_repo_tpu.parallel.batch``, under the
single-process convention of ``parallel/blocked_batch.py``: every
argument is split with ``torch.tensor_split`` (frames over ``dp``, the
flattened index axis over ``sp``; shards may be uneven, empty ones are
not run), each shard runs on its mesh device, and results are gathered
on the mesh's home device.

* :func:`make_sharded_encode` — each shard inserts its indices into a
  partial bit array; the partials are OR-reduced (``torch.amax``, the
  JAX package's ``lax.pmax``) on the home device; each shard then tests
  membership against the full array and compacts its witness, and the
  segments are placed in ascending global index order at the exclusive
  scan of the per-shard pass counts — bit-identical to the unsharded
  core whatever the sharding.
* :func:`make_sharded_decode` — each shard tests membership; the
  exclusive scan of the per-shard pass counts gives each shard the
  offset of its first witness bit.
* The ``make_gop_*_dp`` factories shard the ``models/gop.py`` stages of
  a chunk over frames; the hash tables replicate.

Per-frame k varies with density, so lanes are computed to
``MAX_LANES`` and masked per frame (``ops/bloom_core`` lane-masked
variants).

As in the JAX package, these programs run in one process: a mesh whose
cells belong to several processes reaches the blocked, planar and
byte-view paths only, and every factory here raises ``ValueError`` for
one.
"""

from __future__ import annotations

from functools import partial

import torch

from new_bloom_filter_repo_tpu_torch.models import gop as gop_mod
from new_bloom_filter_repo_tpu_torch.ops.bloom_core import (
    MAX_LANES,
    _exclusive_cumsum,
    insert_partial_lanes,
    membership_lanes,
    witness_compact,
)
from new_bloom_filter_repo_tpu_torch.parallel.blocked_batch import (
    ARR,
    DP,
    REP,
    TAB,
    _pieces,
    run_sharded,
)
from new_bloom_filter_repo_tpu_torch.parallel.mesh import Mesh

# bits (B, n) over (dp, sp); the six (n,) table halves over sp; the four
# per-frame scalars (l, t_hi, t_lo, floor_k) over dp
_TABLES = (TAB,) * 6
_SCALARS = (DP,) * 4


def _one_process(mesh: Mesh) -> Mesh:
    if mesh.multiproc:
        raise ValueError("the BFV2 mesh programs run in one process; a mesh "
                         "over several processes serves the blocked, planar "
                         "and byte-view paths")
    return mesh


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive scan over shards of (B, S) per-shard counts."""
    return torch.cumsum(counts, 1) - counts


def _shard_sizes(n: int, sp: int):
    """Index-shard lengths of the non-empty shards, in order."""
    return [len(p) for p in torch.tensor_split(torch.arange(n), sp)
            if len(p)]


def _flat_tables(fn, at: int):
    """``fn`` taking its (h1, h2, act) table pairs, which start at
    argument ``at``, as six flat tensors, so that :func:`run_sharded`
    can place them."""
    def flat(*args):
        t = args[at:at + 6]
        return fn(*args[:at], (t[0], t[1]), (t[2], t[3]), (t[4], t[5]),
                  *args[at + 6:])
    return flat


def make_sharded_encode(mesh: Mesh, n: int, l_pad: int):
    """The sharded batch-encode step.

    Returns fn(bits (B, n) u8, tables 6 x (n,) int64 halves
    (h1 hi, h1 lo, h2 hi, h2 lo, act hi, act lo), l, t_hi, t_lo,
    floor_k (B,)) -> (bit_arrays (B, l_pad) u8, witness (B, n) u8,
    counts (B,) i32), all on the mesh's home device."""
    _one_process(mesh)
    sizes = _shard_sizes(n, mesh.shape["sp"])

    def insert(bits, h1, h2, act, l, thi, tlo, fk):
        return (insert_partial_lanes(bits, h1, h2, act, l, thi, tlo, fk,
                                     MAX_LANES, l_pad)[:, None],)

    def compact(full, bits, h1, h2, act, l, thi, tlo, fk):
        pmask = membership_lanes(full, h1, h2, act, l, thi, tlo, fk,
                                 MAX_LANES)
        wit, cnt = witness_compact(bits, pmask)
        return wit, cnt[:, None]

    def encode(bits, tables, l, t_hi, t_lo, floor_k):
        args = (bits, *tables, l, t_hi, t_lo, floor_k)
        specs = (ARR,) + _TABLES + _SCALARS
        partials, = run_sharded(mesh, _flat_tables(insert, 1), args, specs,
                                block_axis=True)
        full = partials.amax(1)                      # OR over the sp shards
        segs, counts = run_sharded(mesh, _flat_tables(compact, 2),
                                   (full,) + args, (DP,) + specs,
                                   block_axis=True)
        return full, _place(segs, counts, sizes), counts.sum(
            1, dtype=torch.int32)

    return encode


def _place(segs: torch.Tensor, counts: torch.Tensor, sizes) -> torch.Tensor:
    """Concatenate each shard's first ``counts[:, s]`` witness bits.

    segs: (B, n), shard s's compacted witness at its own index range;
    counts: (B, S).  Bit i of shard s lands at offset[s] + i; the rest
    of the row is zero."""
    b, n = segs.shape
    dev = segs.device
    sizes_t = torch.tensor(sizes, dtype=torch.int64, device=dev)
    shard = torch.repeat_interleave(
        torch.arange(len(sizes), device=dev), sizes_t)
    local = (torch.arange(n, device=dev)
             - (torch.cumsum(sizes_t, 0) - sizes_t)[shard])
    counts = counts.to(torch.int64)
    valid = local[None] < counts[:, shard]
    target = torch.where(valid, _offsets(counts)[:, shard] + local[None], n)
    out = torch.zeros((b, n + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, target, torch.where(valid, segs, 0).to(torch.uint8))
    return out[:, :n]


def make_sharded_decode(mesh: Mesh, n: int, l_pad: int):
    """The sharded batch-decode step.

    Returns fn(bit_arrays (B, l_pad), witness (B, n), tables, l, t_hi,
    t_lo, floor_k) -> bits (B, n) u8 on the mesh's home device."""
    _one_process(mesh)

    def member(bit_arrays, h1, h2, act, l, thi, tlo, fk):
        pmask = membership_lanes(bit_arrays, h1, h2, act, l, thi, tlo, fk,
                                 MAX_LANES)
        return pmask, pmask.sum(1, dtype=torch.int64)[:, None]

    def expand(pmask, witness, offs):
        widx = _exclusive_cumsum(pmask) + offs
        return (torch.where(pmask, torch.gather(witness, 1, widx),
                            0).to(torch.uint8),)

    def decode(bit_arrays, witness, tables, l, t_hi, t_lo, floor_k):
        pmask, counts = run_sharded(
            mesh, _flat_tables(member, 1),
            (bit_arrays, *tables, l, t_hi, t_lo, floor_k),
            (DP,) + _TABLES + _SCALARS, block_axis=True)
        out, = run_sharded(mesh, expand, (pmask, witness, _offsets(counts)),
                           (ARR, DP, ARR), block_axis=True)
        return out

    return decode


def make_gop_masks_dp(mesh: Mesh):
    """Frame-sharded chunk diff masks: (prev, curr) frame pairs shard
    over 'dp' (both operands carry the shift, so no boundary exchange).

    Returns fn(prev (B,h,w[,c]) u8, curr (B,h,w[,c]) u8)
      -> (masks (B,n8) u8, packed (B,n8/8) u8, counts (B,) i32)."""
    _one_process(mesh)
    def masks(prev, curr):
        return run_sharded(mesh, gop_mod.gop_masks_pairs, (prev, curr),
                           (DP, DP), block_axis=False)
    return masks


def make_gop_encode_dp(mesh: Mesh, *, l_pad: int, vmax: int):
    """Frame-sharded chunk Bloom encode over 'dp': frames, masks and
    per-frame scalars shard their leading axis; the hash tables
    replicate.  Same signature and returns as ``models.gop.gop_encode``."""
    _one_process(mesh)
    fn = _flat_tables(partial(gop_mod.gop_encode, l_pad=l_pad, vmax=vmax),
                      2)

    def encode(masks, frames_curr, h1, h2, act, l, t_hi, t_lo, floor_k):
        return run_sharded(mesh, fn,
                           (masks, frames_curr, *h1, *h2, *act,
                            l, t_hi, t_lo, floor_k),
                           (DP, DP) + (REP,) * 6 + _SCALARS,
                           block_axis=False)
    return encode


def make_gop_decode_fields_dp(mesh: Mesh, *, n: int, vmax: int):
    """Frame-sharded decode fields of BFV2 records: membership, witness
    expansion and value gather shard over 'dp'; only the short
    sequential ``gop_chain`` runs unsharded afterwards."""
    _one_process(mesh)
    fn = _flat_tables(partial(gop_mod.gop_decode_fields, n=n, vmax=vmax),
                      4)

    def fields(pb, pw, vals, flags, h1, h2, act, l, t_hi, t_lo, floor_k):
        return run_sharded(mesh, fn,
                           (pb, pw, vals, flags, *h1, *h2, *act,
                            l, t_hi, t_lo, floor_k),
                           (DP,) * 4 + (REP,) * 6 + _SCALARS,
                           block_axis=False)
    return fields


def shard_batch_arrays(mesh: Mesh, bits, tables, scalars):
    """Place batch inputs with their canonical shardings: bits over
    (dp, sp), each table over sp, each per-frame scalar over dp.
    Returns, for each input, a dp x sp grid of tensors, each on its
    mesh cell's device."""
    _one_process(mesh)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    def place(x, spec):
        return [[p.to(mesh.devices[i][j]) for j, p in enumerate(row)]
                for i, row in enumerate(_pieces(x, spec, dp, sp))]

    return (place(bits, ARR), tuple(place(t, TAB) for t in tables),
            tuple(place(s, DP) for s in scalars))
