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

On a mesh whose cells belong to several processes
(``parallel.mesh.initialize_distributed``) every process makes the same
call on identical arguments and runs only the shards of its own cells;
their outputs then reach every process (:func:`_exchange`: two
collectives a call, whatever the number of cells and outputs), so each
returns the full result on its own home device.  This is the
counterpart of the JAX package's ``process_allgather(a, tiled=True)``.
Collectives are matched by call order: a process issues these calls
from one thread, in the same order as every other process.
"""

from __future__ import annotations

from functools import partial
import contextlib
import math
import time
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


_DTYPES = (torch.uint8, torch.bool, torch.int32, torch.int64)
_MAX_OUT, _MAX_DIM, _ALIGN = 8, 4, 16

# The cross-process hop since the last reset_hop(): seconds on the
# host's clock (started once the process's own shards are computed), of
# which wait_seconds in the first collective (the table of shapes, a
# few hundred bytes: the time until the last process arrives), calls,
# and bytes this process received.
_HOP = {"seconds": 0.0, "wait_seconds": 0.0, "calls": 0, "bytes": 0}
_PINNED: dict = {}


def hop_stats() -> dict:
    """Seconds (and those spent waiting for the other processes), calls
    and received bytes of the cross-process hop."""
    return dict(_HOP)


def reset_hop() -> None:
    _HOP.update(seconds=0.0, wait_seconds=0.0, calls=0, bytes=0)


def _pinned(slot, nbytes: int) -> torch.Tensor:
    """A pinned host buffer of at least ``nbytes``, kept per slot and
    grown by doubling: page-locking costs more than the copies."""
    buf = _PINNED.get(slot)
    if buf is None or buf.numel() < nbytes:
        size = max(nbytes, 2 * buf.numel() if buf is not None else 1 << 20)
        buf = _PINNED[slot] = torch.empty(size, dtype=torch.uint8,
                                          pin_memory=True)
    return buf[:nbytes]


def _exchange(mesh: Mesh, results: dict, live: Sequence) -> dict:
    """Give every process the outputs of every live cell.

    ``results`` holds this process's cells, ``{(i, j): tuple of
    tensors}``; ``live`` lists, alike in every process, the cells that
    ran somewhere.  Output shapes are not known to the other processes,
    so a first collective sums a table of every cell's output dtypes and
    shapes (each process fills in its own rows), and a second gathers
    one byte buffer a process, padded to the longest.  CUDA buffers go
    over NCCL between the home cards, or through pinned host memory and
    gloo (``mesh.transport``); both order themselves after the kernels
    on the current stream of each card.  Returns ``{cell: outputs}`` on
    the home device for every live cell."""
    import torch.distributed as dist

    home = mesh.home
    if home.type == "cuda":
        for d in mesh.distinct_devices():
            torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    world = dist.get_world_size()
    owner = {c: mesh.ranks[c[0]][c[1]] for c in live}
    meta = torch.zeros((len(live), _MAX_OUT, 2 + _MAX_DIM), dtype=torch.int64)
    for n, c in enumerate(live):
        outs = results.get(c, ())
        if len(outs) > _MAX_OUT or any(o.ndim > _MAX_DIM for o in outs):
            raise ValueError("a sharded function returns at most "
                             f"{_MAX_OUT} tensors of {_MAX_DIM} axes")
        for k, o in enumerate(outs):
            meta[n, k, 0] = 1 + _DTYPES.index(o.dtype)
            meta[n, k, 1] = o.ndim
            meta[n, k, 2:2 + o.ndim] = torch.tensor(o.shape)
    dist.all_reduce(meta)                      # CPU tensor: gloo
    _HOP["wait_seconds"] += time.perf_counter() - t0
    meta = meta.tolist()

    # every process derives the same layout of every rank's buffer
    layout, fill = {}, [0] * world
    for n, c in enumerate(live):
        specs = []
        for row in meta[n]:
            if row[0] == 0:
                break
            dtype, shape = _DTYPES[row[0] - 1], tuple(row[2:2 + row[1]])
            nbytes = dtype.itemsize * math.prod(shape)
            specs.append((dtype, shape, fill[owner[c]], nbytes))
            fill[owner[c]] += -(-nbytes // _ALIGN) * _ALIGN
        layout[c] = specs
    size = max(fill)
    if size == 0:
        raise RuntimeError("no process reported an output of a live cell")

    with (torch.cuda.device(home) if home.type == "cuda"
          else contextlib.nullcontext()):
        mine = torch.zeros(size, dtype=torch.uint8, device=home)
        for c, outs in results.items():
            for o, (_, _, off, nbytes) in zip(outs, layout[c]):
                mine[off:off + nbytes] = (
                    o.to(home).reshape(-1).view(torch.uint8))
        if mesh.transport == "gloo-staged":
            send = _pinned("send", size)
            send.copy_(mine)                   # blocks until it has landed
            recv = [_pinned(("recv", r), size) for r in range(world)]
            dist.all_gather(recv, send)
            bufs = [b.to(home, non_blocking=True) for b in recv]
        else:                                  # gloo (CPU) or nccl (CUDA)
            bufs = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(bufs, mine)
        full = {}
        for c in live:
            if c in results:
                full[c] = tuple(o.to(home) for o in results[c])
                continue
            buf = bufs[owner[c]]
            full[c] = tuple(
                buf[off:off + nbytes].view(dtype).reshape(shape)
                for dtype, shape, off, nbytes in layout[c])
        if mesh.transport == "gloo-staged":
            # the pinned buffers are reused by the next call
            torch.cuda.current_stream().synchronize()
    _HOP["seconds"] += time.perf_counter() - t0
    _HOP["calls"] += 1
    _HOP["bytes"] += size * (world - 1)
    return full


def run_sharded(mesh: Mesh, fn: Callable, args: Sequence, specs: Sequence,
                *, block_axis: bool) -> tuple:
    """Call ``fn`` on every non-empty shard of ``args`` laid out by
    ``specs`` and gather its outputs (a tuple of tensors, frames on axis
    0, and with ``block_axis`` blocks on axis 1) on the home device.
    Without ``block_axis`` only the mesh's first sp column runs.  Across
    processes each runs its own cells and every process gets the full
    outputs (module docstring)."""
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

    # which cells have work follows from the argument shapes alone, so
    # every process of a mesh finds the same ones
    live = [(i, j) for i in range(dp) for j in range(sp)
            if not any(p[i][j].numel() == 0
                       for p, s in zip(pieces, split) if s)]
    if not live:                    # nothing to shard: run unsharded
        return tuple(fn(*(move(a, mesh.home) for a in args)))
    results = {}
    for i, j in live:
        if mesh.ranks[i][j] == mesh.rank:
            dev = mesh.devices[i][j]
            results[i, j] = fn(*(move(p[i][j], dev) for p in pieces))
    if mesh.multiproc:
        results = _exchange(mesh, results, live)
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
