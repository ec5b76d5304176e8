"""Device meshes for the blocked codec.

The port of ``new_bloom_filter_repo_tpu.parallel.mesh``.  The codec's
parallelism maps onto a 2D logical grid of devices:

* ``dp`` — frame parallelism: the frames of a chunk are independent;
* ``sp`` — block parallelism within a frame: every 1024-item block owns
  its sub-filter, witness segment and value segment, so the block axis
  of an oversized (4K/8K) frame splits with no communication.

A :class:`Mesh` is a plain (dp, sp) grid of cells, each a device of one
process (``parallel/blocked_batch.py`` drives it).  A device may appear
more than once: ``make_mesh(2, 2, ["cpu"] * 4)`` is the counterpart of
the JAX tests' virtual host devices, and ``["cuda:0"] * 4`` lays a mesh
over one card (which measures dispatch, not scaling).

Across processes: every process calls :func:`initialize_distributed`
(``torch.distributed``; one process per host or per card), builds the
same mesh over all processes' devices and makes the same calls on the
same inputs.  Each runs the cells it owns, and every output is
replicated to every process.  How CUDA outputs travel is fixed when the
mesh is built, from the cards gathered at initialization: over NCCL
when every process's home card is a distinct physical card, else (two
processes on one card, which NCCL refuses) staged through pinned host
memory and sent over gloo.  CPU meshes use gloo.
"""

from __future__ import annotations

import atexit
import datetime
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch

# Set by initialize_distributed(): rank, world, device_type, and for
# every rank its devices and their physical identities.
_DIST: Optional[dict] = None
# A peer that does not answer a collective within this time is an error.
GROUP_TIMEOUT_S = 120.0


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _cell(entry, me: int):
    """A mesh entry as (rank, device): a plain device belongs to this
    process, a ``(rank, device)`` pair to the process it names.  Another
    process's device keeps the name it has there."""
    if isinstance(entry, (tuple, list)):
        rank, dev = int(entry[0]), entry[1]
        return rank, (_device(dev) if rank == me else torch.device(dev))
    return me, _device(entry)


class Mesh:
    """A (dp, sp) grid of cells: cell (i, j) runs frame shard i, block
    shard j on ``devices[i][j]`` of process ``ranks[i][j]``.  ``home``,
    this process's first own cell, is where it gathers results.  An
    entry is a device of this process or a ``(rank, device)`` pair; a
    mesh whose cells belong to several processes (``multiproc``) needs
    :func:`initialize_distributed` first, and every process builds it
    alike.  ``transport`` says how outputs reach the other processes:
    ``"local"``, ``"gloo"`` (CPU tensors), ``"nccl"`` or
    ``"gloo-staged"`` (CUDA tensors through pinned host memory)."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: Sequence[Sequence]):
        self.rank = _DIST["rank"] if _DIST else 0
        cells = tuple(tuple(_cell(d, self.rank) for d in row)
                      for row in devices)
        if not cells or not cells[0] or any(len(r) != len(cells[0])
                                            for r in cells):
            raise ValueError("a mesh is a non-empty (dp, sp) grid of devices")
        self.ranks: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(r for r, _ in row) for row in cells)
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(d for _, d in row) for row in cells)
        flat = [c for row in cells for c in row]
        own = [d for r, d in flat if r == self.rank]
        if not own:
            raise ValueError(f"process {self.rank} owns no cell of the mesh "
                             f"(ranks {sorted({r for r, _ in flat})})")
        self.home: torch.device = own[0]
        self.multiproc = len({r for r, _ in flat}) > 1
        self.transport = self._transport(flat) if self.multiproc else "local"

    @staticmethod
    def _transport(flat) -> str:
        """Fixed here, from what initialize_distributed gathered."""
        if _DIST is None:
            raise ValueError("a mesh over several processes needs "
                             "initialize_distributed() first")
        types = {d.type for _, d in flat}
        if types != {_DIST["device_type"]}:
            raise ValueError(f"the mesh's devices {sorted(types)} are not "
                             f"of the initialized type "
                             f"({_DIST['device_type']})")
        if {r for r, _ in flat} != set(range(_DIST["world"])):
            raise ValueError(f"a mesh over several processes gives every "
                             f"one of the {_DIST['world']} a cell: its "
                             f"collectives include them all")
        homes = {}
        for r, d in flat:
            if d.type == "cuda" and (d.index or 0) >= len(_DIST["cards"][r]):
                raise ValueError(f"process {r} has no {d}")
            homes.setdefault(r, d)
        if _DIST["device_type"] != "cuda":
            return "gloo"
        cards = [_DIST["cards"][r][d.index or 0] for r, d in homes.items()]
        if len(set(cards)) < len(cards):
            return "gloo-staged"       # NCCL refuses two ranks on one card
        if not _DIST["nccl"]:
            raise RuntimeError("processes on distinct cards need NCCL, "
                               "which this PyTorch build lacks")
        return "nccl"

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """This process's devices in the mesh, each once, in grid order."""
        return tuple(dict.fromkeys(
            d for rr, row in zip(self.ranks, self.devices)
            for r, d in zip(rr, row) if r == self.rank))

    def __repr__(self) -> str:
        cells = [str(d) if not self.multiproc else f"{r}:{d}"
                 for rr, row in zip(self.ranks, self.devices)
                 for r, d in zip(rr, row)]
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={cells})")


def _local_cards(device_type: str):
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def _cards(device_type: str):
    """Every device of ``device_type``: this process's, or after
    :func:`initialize_distributed` with that type every process's, as
    (rank, device) pairs in rank order."""
    if _DIST is not None and _DIST["device_type"] == device_type:
        return [(r, torch.device(device_type, i) if device_type == "cuda"
                 else torch.device(device_type))
                for r, cards in enumerate(_DIST["cards"])
                for i in range(len(cards))]
    return _local_cards(device_type)


def make_mesh(dp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """A (dp, sp) mesh over the first dp*sp entries of ``devices``
    (default: every CUDA card; after :func:`initialize_distributed`,
    every process's devices in rank order).  An entry is a device of
    this process or a ``(rank, device)`` pair; entries may repeat."""
    if devices is None:
        devices = _cards(_DIST["device_type"] if _DIST else "cuda")
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
    for block sharding within a frame.  After
    :func:`initialize_distributed` the devices of every process count.

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


def _card_ids():
    """A physical identity for each of this process's cards."""
    host = socket.gethostname()
    ids = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        ids.append((host, str(getattr(p, "uuid", None)
                              or (p.pci_domain_id, p.pci_bus_id,
                                  p.pci_device_id))))
    return ids


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device_type: str = "cuda") -> dict:
    """Join this process to the others of a multi-process mesh.

    A wrapper over ``torch.distributed.init_process_group``: with the
    arguments, ``tcp://<coordinator_address>`` (``"host:port"``),
    ``num_processes`` and ``process_id``; without them, the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as
    ``torchrun`` sets them).  ``device_type`` says what the processes
    drive: ``"cuda"`` (gloo for host data, NCCL between cards; raises
    ``RuntimeError`` without a card) or ``"cpu"`` (gloo).  A peer that
    does not answer within ``GROUP_TIMEOUT_S`` seconds is an error, not
    a hang.  Afterwards ``make_mesh()`` / ``auto_mesh()`` span every
    process's devices, and each process's cards are known to all, which
    fixes every later mesh's transport (:class:`Mesh`).

    Idempotent: repeat calls return the existing state.  Returns
    {"process_id", "num_processes", "local_devices", "global_devices"}.
    A group made here is left through :func:`shutdown_distributed` when
    the interpreter exits.
    """
    import torch.distributed as dist

    global _DIST
    if _DIST is None:
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('no CUDA card: pass device_type="cpu" to run '
                               'the processes on the CPU')
        nccl = device_type == "cuda" and dist.is_nccl_available()
        if not dist.is_initialized():
            dist.init_process_group(
                "cpu:gloo,cuda:nccl" if nccl else "gloo",
                init_method=("env://" if coordinator_address is None
                             else f"tcp://{coordinator_address}"),
                world_size=-1 if num_processes is None else num_processes,
                rank=-1 if process_id is None else process_id,
                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
            atexit.register(shutdown_distributed)
        world = dist.get_world_size()
        cards = [None] * world
        dist.all_gather_object(
            cards, _card_ids() if device_type == "cuda"
            else [(socket.gethostname(), "cpu")])
        _DIST = {"rank": dist.get_rank(), "world": world,
                 "device_type": device_type, "cards": cards, "nccl": nccl}
    me = _DIST["cards"][_DIST["rank"]]
    return {"process_id": _DIST["rank"], "num_processes": _DIST["world"],
            "local_devices": len(me),
            "global_devices": sum(len(c) for c in _DIST["cards"])}


def shutdown_distributed() -> None:
    """Leave the process group: wait until every process has got here,
    then close the connections.  A process that exits while a peer still
    holds its connections open can abort that peer."""
    import torch.distributed as dist

    global _DIST
    _DIST = None
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1))        # a barrier over gloo
        dist.destroy_process_group()
