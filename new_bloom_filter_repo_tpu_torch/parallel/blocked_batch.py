"""Frame- and block-sharded programs of the blocked (BFV3) kernels.

The port of ``new_bloom_filter_repo_tpu.parallel.blocked_batch``.  Both
axes of the blocked profile are collective-free:

* ``dp`` — frames are independent (every frame carries its own
  sub-filters, witness segments and value segments);
* ``sp`` — the 1024-item blocks of a frame are independent too, so an
  oversized frame shards its block axis over ``sp``.

Each factory returns a plain callable with the argument order of the
``ops/blocked.py`` wrapper it shards.  A call splits every frame-sharded
argument's frame axis over dp and every block-sharded argument's block
axis over sp (``torch.tensor_split``: shards may be uneven or empty),
moves each shard to its mesh device (a replicated argument is copied
once per distinct device), calls the wrapper on each shard, and
concatenates the results on the mesh's home device.  Kernel launches
are asynchronous, so shards on distinct cards are meant to run at the
same time (not yet measured); the gathering copies order themselves
after the work on each card.  Shards
with no frame or no block are not launched.  Where JAX's ``shard_map``
needed equal shards, and the pipeline padded for it, nothing is padded
here.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch

from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.parallel.mesh import Mesh

# Argument layouts (the JAX package's PartitionSpecs)
DP = "dp"        # P("dp"): frame axis (0) over dp, replicated over sp
ARR = "dpsp"     # P("dp", "sp"): frames over dp, blocks (axis 1) over sp
TAB = "sp"       # P("sp"): per-geometry (NB, IPB) tables, blocks over sp
REP = None       # P(): replicated


def _pieces(x: torch.Tensor, spec, dp: int, sp: int):
    """x's piece for every grid cell, as a dp x sp nested list."""
    if spec == DP:
        return [[r] * sp for r in torch.tensor_split(x, dp, 0)]
    if spec == ARR:
        return [list(torch.tensor_split(r, sp, 1))
                for r in torch.tensor_split(x, dp, 0)]
    if spec == TAB:
        return [list(torch.tensor_split(x, sp, 0))] * dp
    return [[x] * sp] * dp


def run_sharded(mesh: Mesh, fn: Callable, args: Sequence, specs: Sequence,
                *, block_axis: bool) -> tuple:
    """Call ``fn`` on every non-empty shard of ``args`` laid out by
    ``specs`` and gather its outputs (a tuple of tensors, frames on axis
    0, and with ``block_axis`` blocks on axis 1) on the home device.
    Without ``block_axis`` only the mesh's first sp column runs."""
    if len(args) != len(specs):
        raise TypeError(f"expected {len(specs)} arguments, got {len(args)}")
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"] if block_axis else 1
    pieces = [_pieces(a, s, dp, sp) for a, s in zip(args, specs)]
    split = [s is not REP for s in specs]
    copies = {}

    def move(x, dev):
        key = (id(x), dev)
        if key not in copies:
            copies[key] = x.to(dev).contiguous()
        return copies[key]

    results = {}
    for i in range(dp):
        for j in range(sp):
            cell = [p[i][j] for p in pieces]
            if any(c.numel() == 0 for c, s in zip(cell, split) if s):
                continue
            dev = mesh.devices[i][j]
            results[i, j] = fn(*(move(c, dev) for c in cell))
    if not results:                 # nothing to shard: run unsharded
        return tuple(fn(*(move(a, mesh.home) for a in args)))
    n_out = len(next(iter(results.values())))
    home = mesh.home
    outs = []
    for k in range(n_out):
        rows = []
        for i in range(dp):
            cols = [results[i, j][k].to(home) for j in range(sp)
                    if (i, j) in results]
            if cols:
                rows.append(torch.cat(cols, 1) if block_axis else cols[0])
        outs.append(torch.cat(rows, 0))
    return tuple(outs)


def sharded(mesh: Mesh, fn: Callable, specs: Sequence, *,
            block_axis: bool) -> Callable:
    """``fn`` as a callable sharded over ``mesh`` (see :func:`run_sharded`)."""
    def call(*args):
        return run_sharded(mesh, fn, args, specs, block_axis=block_axis)
    return call


def _kw(nw, **kw):
    if nw is not None:
        kw["nw"] = nw
    return kw


def make_blocked_encode_dp(mesh: Mesh, *, k_lanes: int, vh: int,
                           nw: int = None):
    """Frame-sharded K5a encode; signature and returns of
    ``ops.blocked.blocked_encode``."""
    fn = partial(bk.blocked_encode, **_kw(nw, k_lanes=k_lanes, vh=vh))
    return sharded(mesh, fn, (DP,) * 7, block_axis=False)


def make_blocked_encode_dpsp(mesh: Mesh, *, k_lanes: int, vh: int,
                             nw: int = None):
    """K5a encode sharded over frames (dp) and blocks (sp)."""
    fn = partial(bk.blocked_encode, **_kw(nw, k_lanes=k_lanes, vh=vh))
    return sharded(mesh, fn, (ARR,) * 5 + (DP, DP), block_axis=True)


def make_blocked_encode_h_dp(mesh: Mesh, *, k_lanes: int, vh: int,
                             nw: int = None):
    """Frame-sharded K1 encode: the per-geometry tables (h1, h2, act_hi,
    act_lo) replicate; argument order of ``blocked_encode_h``."""
    fn = partial(bk.blocked_encode_h, **_kw(nw, k_lanes=k_lanes, vh=vh))
    return sharded(mesh, fn, (DP, REP, REP, REP, REP) + (DP,) * 5,
                   block_axis=False)


def make_blocked_encode_h_dpsp(mesh: Mesh, *, k_lanes: int, vh: int,
                               nw: int = None):
    """K1 encode sharded over frames and blocks; the tables shard their
    block axis over sp."""
    fn = partial(bk.blocked_encode_h, **_kw(nw, k_lanes=k_lanes, vh=vh))
    return sharded(mesh, fn, (ARR, TAB, TAB, TAB, TAB, ARR) + (DP,) * 4,
                   block_axis=True)


def make_blocked_membership_h_dp(mesh: Mesh, *, k_lanes: int,
                                 nw: int = None):
    """Frame-sharded K2 membership pass."""
    fn = partial(bk.blocked_membership_h, **_kw(nw, k_lanes=k_lanes))
    return sharded(mesh, fn, (DP, REP, REP, REP, REP) + (DP,) * 5,
                   block_axis=False)


def make_blocked_membership_h_dpsp(mesh: Mesh, *, k_lanes: int,
                                   nw: int = None):
    """K2 membership sharded over frames and blocks."""
    fn = partial(bk.blocked_membership_h, **_kw(nw, k_lanes=k_lanes))
    return sharded(mesh, fn, (ARR, TAB, TAB, TAB, TAB) + (DP,) * 5,
                   block_axis=True)


def _decode_fn(*, k_lanes, vh, nw):
    mkw = _kw(nw, k_lanes=k_lanes)

    def fn(words, a, b, act, m, fk, flags, wit, raw, vseg):
        passes, wcnt = bk.blocked_membership(words, a, b, act, m, fk, flags,
                                             **mkw)
        mask, vals = bk.blocked_expand(passes, wit, raw, flags, vseg, vh=vh)
        return passes, wcnt, mask, vals

    return fn


def make_blocked_decode_dp(mesh: Mesh, *, k_lanes: int, vh: int,
                           nw: int = None):
    """Frame-sharded K5b membership + K4 expansion.  Arguments
    ``(words, a, b, act, m, floor_k, flags, wit, raw_mask, vseg)``;
    returns ``(passes, wcnt, mask, vals)``."""
    return sharded(mesh, _decode_fn(k_lanes=k_lanes, vh=vh, nw=nw),
                   (DP,) * 10, block_axis=False)


def make_blocked_decode_dpsp(mesh: Mesh, *, k_lanes: int, vh: int,
                             nw: int = None):
    """K5b membership + K4 expansion sharded over frames and blocks:
    the per-frame scalars (m, floor_k, flags) replicate over sp."""
    return sharded(mesh, _decode_fn(k_lanes=k_lanes, vh=vh, nw=nw),
                   (ARR,) * 4 + (DP,) * 3 + (ARR,) * 3, block_axis=True)


def make_blocked_membership_dp(mesh: Mesh, *, k_lanes: int,
                               nw: int = None):
    """Frame-sharded K5b membership pass."""
    fn = partial(bk.blocked_membership, **_kw(nw, k_lanes=k_lanes))
    return sharded(mesh, fn, (DP,) * 7, block_axis=False)


def make_blocked_membership_dpsp(mesh: Mesh, *, k_lanes: int,
                                 nw: int = None):
    """K5b membership sharded over frames and blocks."""
    fn = partial(bk.blocked_membership, **_kw(nw, k_lanes=k_lanes))
    return sharded(mesh, fn, (ARR,) * 4 + (DP,) * 3, block_axis=True)


def make_blocked_expand_dp(mesh: Mesh, *, vh: int):
    """Frame-sharded K4 witness/value expansion."""
    return sharded(mesh, partial(bk.blocked_expand, vh=vh), (DP,) * 5,
                   block_axis=False)


def make_blocked_expand_dpsp(mesh: Mesh, *, vh: int):
    """K4 expansion sharded over frames and blocks."""
    return sharded(mesh, partial(bk.blocked_expand, vh=vh),
                   (ARR, ARR, ARR, DP, ARR), block_axis=True)
