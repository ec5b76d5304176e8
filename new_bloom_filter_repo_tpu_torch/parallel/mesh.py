"""Device meshes for the blocked codec.

The port of ``new_bloom_filter_repo_tpu.parallel.mesh``.  The codec's
parallelism maps onto a 2D logical grid of devices:

* ``dp`` — frame parallelism: the frames of a chunk are independent;
* ``sp`` — block parallelism within a frame: every 1024-item block owns
  its sub-filter, witness segment and value segment, so the block axis
  of an oversized (4K/8K) frame splits with no communication.

A :class:`Mesh` is a plain (dp, sp) grid of ``torch.device``s, driven
from one process (``parallel/blocked_batch.py``).  A device may appear
more than once: ``make_mesh(2, 2, ["cpu"] * 4)`` is the counterpart of
the JAX tests' virtual host devices, and ``["cuda:0"] * 4`` lays a mesh
over one card (which measures dispatch, not scaling).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (dp, sp) grid of devices: ``devices[i][j]`` runs frame shard i,
    block shard j.  ``devices[0][0]`` is the home device, where sharded
    results are gathered."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: Sequence[Sequence]):
        rows = tuple(tuple(_device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty (dp, sp) grid of devices")
        self.devices: Tuple[Tuple[torch.device, ...], ...] = rows

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in grid order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for row in self.devices for d in row]})")


def _cards(device_type: str):
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(dp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """A (dp, sp) mesh over the first dp*sp entries of ``devices``
    (default: every CUDA card).  Entries may repeat."""
    if devices is None:
        devices = _cards("cuda")
    devices = list(devices)
    need = dp * sp
    if dp < 1 or sp < 1:
        raise ValueError(f"dp and sp must be >= 1, got ({dp}, {sp})")
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


def auto_mesh(n_devices: Optional[int] = None, sp: int = 1,
              device_type: str = "cuda") -> Mesh:
    """All ``n_devices`` (default: every) distinct devices of
    ``device_type`` on frame parallelism, with ``sp`` of them reserved
    for block sharding within a frame.

    Raises ``ValueError`` when there are fewer such devices than asked
    for.  Unlike the JAX package it never falls back to virtual host
    devices: that would move a CUDA run onto the CPU without a word.
    Build a mesh with repeated devices through :func:`make_mesh`."""
    cards = _cards(device_type)
    n = n_devices or len(cards)
    if n == 0 or len(cards) < n:
        raise ValueError(f"need {n or 1} {device_type} devices, have "
                         f"{len(cards)}")
    if n % sp != 0:
        raise ValueError(f"sp={sp} must divide device count {n}")
    return make_mesh(n // sp, sp, cards[:n])


def default_device(device=None) -> torch.device:
    """``device``, or the current CUDA card when it is None.  Raises
    ``RuntimeError`` when no device is named and there is no card: the
    port runs on the CPU only when asked to."""
    if device is not None:
        return _device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA card: pass device="cpu" to run on the '
                           'CPU')
    return torch.device("cuda", torch.cuda.current_device())


def home_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """The device a pipeline keeps its tensors on: the mesh's home
    device, or :func:`default_device` of ``device`` without a mesh.  A
    ``device`` of another type than the mesh's raises ``ValueError``."""
    if mesh is None:
        return default_device(device)
    if device is not None and torch.device(device).type != mesh.home.type:
        raise ValueError(f"device={device!r} is not of the mesh's device "
                         f"type ({mesh.home.type})")
    return mesh.home


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> dict:
    """Multi-process meshes (``torch.distributed``) are not ported yet."""
    raise NotImplementedError(
        "multi-process meshes (initialize_distributed) are not ported to "
        "the PyTorch package yet (ROADMAP Queue 1 item 11)")
