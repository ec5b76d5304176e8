"""Per-geometry hash tables of the blocked codec, built on the host.

The JAX package computes the three u64 lane tables

    h1[i]  = xxh64(str(i), h1_seed)
    h2[i]  = xxh64(str(i), h2_seed)
    act[i] = xxh64(str(i), activation_seed)

with an xxh64 written over u32 pairs on its device lanes
(``new_bloom_filter_repo_tpu.ops.hashtables``).  Here the threaded C++
host library (``native/libnbf.so``) computes them once per geometry and
the results are uploaded: the tables depend only on the frame size, so
their cost is set-up, never per frame.

:func:`blocked_tables` is the counterpart of
``new_bloom_filter_repo_tpu.models.blocked_pipeline.blocked_tables``
without its pad of the block axis to a multiple of 64 (``nbk_of``): that
pad only served the TPU's grid tiles and never reaches the stream, so
the kernels here run on exactly ``nb`` blocks.

:func:`get_hash_tables` is the counterpart of
``new_bloom_filter_repo_tpu.ops.hashtables.get_hash_tables``, the full
64-bit tables of the BFV2 cores (``ops/bloom_core.py``), held as
non-negative int64 ``(hi, lo)`` halves.  The JAX package's
``ops/u64.py`` and ``ops/xxh64.py`` only existed because the TPU has no
64-bit lanes; they have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.models.bloom import (
    VIDEO_ACTIVATION_SEED,
    VIDEO_H1_SEED,
    VIDEO_H2_SEED,
)
from new_bloom_filter_repo_tpu_torch.utils import native

SEED_SETS = {
    # the .bfvc video codec
    "video": (VIDEO_H1_SEED, VIDEO_H2_SEED, VIDEO_ACTIVATION_SEED),
    # the standalone image/text codec (models/image_text.py)
    "compress": (0, 1, VIDEO_ACTIVATION_SEED),
}

IPB = 1024            # items per block (ops/blocked.IPB)
SUPER = IPB * 8       # geometry padding granularity: sets nb, so it is
                      # part of the stream (m = round(l / nb))
_MASK24 = 0xFFFFFF


def npad_of(n: int) -> int:
    """Padded item count of an n-pixel frame (a multiple of SUPER)."""
    return ((n + SUPER - 1) // SUPER) * SUPER


@lru_cache(maxsize=8)
def _host_tables(n: int) -> Dict[str, np.ndarray]:
    npad = npad_of(n)
    nb = npad // IPB
    h1, h2, act = native.xxh64_index_tables(
        npad, VIDEO_H1_SEED, VIDEO_H2_SEED, VIDEO_ACTIVATION_SEED)

    def low24(x):
        return (x & _MASK24).astype(np.int32).reshape(nb, IPB)

    def half(x):
        return x.astype(np.uint32).view(np.int32).reshape(nb, IPB)

    return {"h1": low24(h1), "h2": low24(h2),
            "act_hi": half(act >> np.uint64(32)),
            "act_lo": half(act & np.uint64(0xFFFFFFFF))}


@lru_cache(maxsize=8)
def _device_tables(n: int, device: torch.device) -> Dict[str, object]:
    host = _host_tables(n)
    out: Dict[str, object] = {"npad": npad_of(n),
                              "nb": npad_of(n) // IPB}
    for k, v in host.items():
        out[k] = torch.from_numpy(v).to(device)
    return out


def blocked_tables(n: int, device="cpu") -> Dict[str, object]:
    """Tables for an n-pixel geometry on ``device``.

    Returns ``{"nb", "npad", "h1", "h2", "act_hi", "act_lo"}``: h1/h2 are
    the low 24 bits of the u64 hashes as int32 (NB, 1024); act_hi/act_lo
    the u32 halves of the activation hash as int32 bit patterns.  Cached
    per (n, device); callers must not write into the tensors."""
    return _device_tables(n, torch.device(device))


def tables_from_numpy(tab: dict) -> Dict[str, object]:
    """The JAX package's ``blocked_tables(n)`` (converted to numpy) as
    this package's CPU tensors: block rows beyond ``nb`` (the TPU grid
    pad) are dropped and the u32 activation halves become int32 bit
    patterns.  Lets a test feed both packages identical state."""
    nb = int(tab["nb"])
    out: Dict[str, object] = {"nb": nb, "npad": int(tab["npad"])}
    for k in ("h1", "h2", "act_hi", "act_lo"):
        a = np.ascontiguousarray(np.asarray(tab[k])[:nb])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a.astype(np.int32, copy=False).copy())
    return out


@dataclass(frozen=True)
class HashTables:
    """u64 lane tables of indices [0, n), each a ``(hi, lo)`` pair of
    int64 tensors with values in [0, 2**32)."""

    n: int
    h1: tuple
    h2: tuple
    act: tuple


def _halves(x: np.ndarray, device) -> tuple:
    x = np.asarray(x, np.uint64)
    return tuple(torch.from_numpy(v.astype(np.int64)).to(device)
                 for v in (x >> np.uint64(32), x & np.uint64(0xFFFFFFFF)))


@lru_cache(maxsize=16)
def _hash_tables(n: int, seed_set: str, device: torch.device) -> HashTables:
    h1, h2, act = native.xxh64_index_tables(n, *SEED_SETS[seed_set])
    return HashTables(n=n, h1=_halves(h1, device), h2=_halves(h2, device),
                      act=_halves(act, device))


def get_hash_tables(n: int, seed_set: str = "video",
                    device="cpu") -> HashTables:
    """The lane tables ``xxh64(str(i), seed)`` of indices [0, n) for
    ``seed_set`` ("video" or "compress") on ``device``.  Cached per (n,
    seed set, device); callers must not write into the tensors."""
    if seed_set not in SEED_SETS:
        raise ValueError(f"unknown seed set: {seed_set!r}")
    return _hash_tables(int(n), seed_set, torch.device(device))


def hash_tables_from_numpy(tables) -> HashTables:
    """The JAX package's ``HashTables`` (u32 ``(hi, lo)`` pairs; any
    array type numpy converts) as this package's CPU tables.  Lets a test
    feed both packages identical state."""
    def pair(p):
        return tuple(torch.from_numpy(np.asarray(v).astype(np.int64))
                     for v in p)

    return HashTables(n=int(tables.n), h1=pair(tables.h1),
                      h2=pair(tables.h2), act=pair(tables.act))
