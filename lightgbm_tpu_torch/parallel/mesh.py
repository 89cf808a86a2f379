"""The (batch, feature) device mesh of the data-parallel learner.

The port of the subset of ``lightgbm_tpu/parallel/mesh.py`` that the
GSPMD learner and the streamed grower use: the axis names (:20-26),
``make_named_mesh`` (:65), ``MeshPlanError`` (:90),
``default_chunk_rows`` (:244), ``parse_mesh_shape`` (:377) and
``pad_rows`` (:609); and the bring-up of a training over several
processes (:29, :430-580; below).  A :class:`Mesh` is a
``(data, feature)`` grid of ``torch.device``s: rows shard over ``batch``,
the histogram's columns over ``feature``.

**Mesh slots.**  The JAX package builds its mesh over ``jax.devices()``,
and its test suite runs on eight virtual CPU devices.  PyTorch has no
virtual devices, so the port's counterpart of ``jax.devices()`` is a list
of *mesh slots* (:func:`mesh_slots`), and one device may fill several
slots:

* ``mesh_devices = k > 0``: ``k`` slots.  On ``cuda`` they go round-robin
  over the visible cards (slot ``s`` on card ``s % cards``), with a
  warning when cards are shared; on ``cpu`` they are ``k`` CPU slots.
* ``mesh_devices = 0``: one slot per visible card on ``cuda``, one slot on
  ``cpu``.

So ``mesh_devices=8, device=cpu`` is the stand-in for the JAX suite's
eight virtual devices, and ``mesh_devices=4`` on one card puts four row
shards on that card.  This is the only place the port departs from the
JAX meaning of ``mesh_devices``, which caps the real devices used.

**Several processes** (``num_machines > 1``, the reference's
``machine_list_file`` of ``ip port`` lines): each process is one rank of a
``torch.distributed`` process group at ``tcp://<machine 0's ip>:<its
port>`` (:func:`init_distributed_from_config`), and holds its own mesh of
slots, the same shape on every rank.  Its slots start at card
``local_rank % cards`` (``local_rank``: the ranks before it on its host),
and ``mesh_devices=0`` is one slot a process there.  The backend follows
the layout and is never a fallback: gloo for CPU tensors; NCCL when every
rank of a host has a card of its own; gloo carrying CUDA tensors when
ranks share a card, which NCCL refuses.  Host objects always ride a gloo
group (``parallel/sync.py``).
"""
from __future__ import annotations

import datetime
import os
import socket
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils import log
from . import sync

# GSPMD mesh axes: rows shard over ``batch``, the histogram pool over
# ``feature``
BATCH_AXIS = "batch"
FEATURE_AXIS = "feature"


class MeshPlanError(RuntimeError):
    """A mesh shape that the available slots cannot serve."""


class Mesh:
    """A ``(data, feature)`` grid of devices; ``devices[i][j]`` holds the
    rows of batch shard ``i`` and the columns of feature slice ``j``."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in devices]
        self.shape = {BATCH_AXIS: len(self.devices),
                      FEATURE_AXIS: len(self.devices[0])}

    @property
    def primary(self) -> torch.device:
        """The device that holds the histogram pool and the split scan."""
        return self.devices[0][0]


def mesh_slots(mesh_devices: int, device: torch.device) -> List[torch.device]:
    """This process's mesh slots for ``device``'s type (module
    docstring): under several processes they start at the process's own
    card, and ``mesh_devices=0`` is that one card."""
    if device.type == "cpu":
        return [torch.device("cpu")] * max(1, mesh_devices)
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("no CUDA card is visible for the mesh")
    # init_distributed_from_config made the process's card current
    multi = sync.process_count() > 1
    first = torch.cuda.current_device() if multi else 0
    k = mesh_devices or (1 if multi else cards)
    if k > cards:
        log.warning("mesh_devices=%d over %d visible card(s): %d mesh "
                    "slots share each card", k, cards, -(-k // cards))
    return [torch.device("cuda", (first + s) % cards) for s in range(k)]


def make_named_mesh(data: int, feature: int,
                    devices: Optional[Sequence[torch.device]] = None
                    ) -> Mesh:
    """``(batch, feature)`` mesh over the first ``data * feature`` slots,
    batch-major (``lightgbm_tpu/parallel/mesh.py:65``)."""
    devs = list(devices) if devices is not None else [torch.device("cpu")]
    need = data * feature
    if need > len(devs):
        raise MeshPlanError(
            f"mesh shape {data}x{feature} needs {need} devices; "
            f"{len(devs)} available")
    return Mesh([devs[i * feature:(i + 1) * feature] for i in range(data)])


def mesh_shape_extents(spec: str):
    """The syntax of the ``mesh_shape`` parameter: ``None`` for ``auto``,
    ``"data"`` or ``"feature"`` (all slots on that axis), or the ``(data,
    feature)`` extents of ``DxF`` (``2x4``, or ``2*4``); ValueError for
    anything else."""
    s = str(spec or "auto").strip().lower()
    if s in ("", "auto"):
        return None
    if s in ("data", "feature"):
        return s
    m = s.replace("*", "x").split("x")
    if len(m) == 2 and all(p.strip().isdigit() for p in m):
        d, f = int(m[0]), int(m[1])
        if d < 1 or f < 1:
            raise ValueError(f"mesh_shape extents must be >= 1; got {spec!r}")
        return (d, f)
    raise ValueError(
        f"mesh_shape must be 'auto', 'data', 'feature', or 'DxF' "
        f"(e.g. 2x4); got {spec!r}")


def parse_mesh_shape(spec: str, n_devices: int):
    """``mesh_shape`` parameter -> (data, feature) extents over
    ``n_devices`` slots, or None for ``auto``; rejects shapes the slot
    count cannot serve."""
    ext = mesh_shape_extents(spec)
    if ext is None:
        return None
    if ext == "data":
        return (n_devices, 1)
    if ext == "feature":
        return (1, n_devices)
    d, f = ext
    if d * f > n_devices:
        raise ValueError(f"mesh_shape {d}x{f} needs {d * f} devices; only "
                         f"{n_devices} available")
    return (d, f)


def default_chunk_rows(rows: int, requested: int = 0) -> int:
    """Streamed block size (``data_stream=chunked``): the explicit
    ``stream_chunk_rows`` when given (clamped to the row count), else
    262,144 rows capped at ``ceil(rows / 2)``, so that even a small
    dataset streams at least two blocks: the double buffer is pointless
    with one."""
    rows = max(1, int(rows))
    if requested and int(requested) > 0:
        return min(int(requested), rows)
    return max(1, min(262144, -(-rows // 2)))


def pad_rows(n: int, shards: int) -> int:
    """Rows padded so every shard gets an equal slice."""
    return (-n) % shards


# ---- several processes (lightgbm_tpu/parallel/mesh.py:29, :430-580) ------


def distributed_is_initialized() -> bool:
    """Whether this process's group is up (:29)."""
    return dist.is_available() and dist.is_initialized()


def shutdown_distributed() -> None:
    """Tear the process group down (idempotent, :430)."""
    if distributed_is_initialized():
        dist.destroy_process_group()
    sync.unbind()


def parse_machine_list(path: str) -> List[Tuple[str, int]]:
    """The reference's machine list (``src/network/linkers.cpp``): one
    ``ip port`` pair a line (:482)."""
    machines = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                machines.append((parts[0], int(parts[1])))
    return machines


def _local_rank(machines) -> Optional[int]:
    """This process's rank in the machine list (:523): ``LGBM_TPU_RANK``
    if set, else the one entry whose address is this host's (the
    reference's rank discovery); None when several entries are."""
    env = os.environ.get("LGBM_TPU_RANK")
    if env is not None:
        return int(env)
    try:
        local = {"127.0.0.1", "localhost", socket.gethostname(),
                 socket.gethostbyname(socket.gethostname())}
    except OSError:
        local = {"127.0.0.1", "localhost"}
    matches = [i for i, (ip, _) in enumerate(machines) if ip in local]
    if len(matches) > 1:
        return None
    return matches[0] if matches else None


def choose_backend(machines, rank: int, device: torch.device):
    """``(backend, local_rank)`` for the layout (module docstring):
    ``local_rank`` counts the ranks listed before this one on its host,
    and NCCL is chosen only when every host lists no more ranks than this
    host has cards, so each rank has a card of its own."""
    ip = machines[rank][0]
    local_rank = sum(1 for m_ip, _ in machines[:rank] if m_ip == ip)
    if device.type == "cpu":
        return "gloo", local_rank
    per_host = max(Counter(m_ip for m_ip, _ in machines).values())
    if per_host <= torch.cuda.device_count():
        return "nccl", local_rank
    return "gloo", local_rank


def init_distributed_from_config(cfg) -> Optional[str]:
    """Bring the process group up from ``num_machines`` and
    ``machine_list_file`` (:545, the reference CLI's network bring-up):
    machine 0's address and port are the rendezvous, the rank is
    :func:`_local_rank`'s, the timeout ``collective_timeout``.  A card
    training makes its card current first (``local_rank % cards``).
    Returns the tensors' backend, or None with one machine; within a
    process a second call returns the running group's backend."""
    if cfg.num_machines <= 1:
        return None
    if distributed_is_initialized():
        return dist.get_backend()
    if not cfg.machine_list_file:
        log.fatal("num_machines=%d but no machine_list_file given",
                  cfg.num_machines)
    machines = parse_machine_list(cfg.machine_list_file)[:cfg.num_machines]
    if len(machines) < cfg.num_machines:
        log.fatal("machine_list_file lists %d machines, num_machines=%d",
                  len(machines), cfg.num_machines)
    rank = _local_rank(machines)
    if rank is None:
        log.fatal("cannot determine this machine's rank: no local address "
                  "in %s (set LGBM_TPU_RANK)", cfg.machine_list_file)
    device = torch.device("cpu" if cfg.device == "cpu" else "cuda")
    backend, local_rank = choose_backend(machines, rank, device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    address = f"tcp://{machines[0][0]}:{machines[0][1]}"
    timeout = datetime.timedelta(seconds=float(cfg.collective_timeout))
    log.info("Initializing process group: %d machines, rank %d (local rank "
             "%d), %s, backend %s", len(machines), rank, local_rank, address,
             backend)
    sync.bind(None, cfg.collective_timeout)
    sync._run("init_process_group", lambda: dist.init_process_group(
        backend, init_method=address, world_size=len(machines), rank=rank,
        timeout=timeout))
    if backend != "gloo":
        sync.bind(dist.new_group(backend="gloo", timeout=timeout),
                  cfg.collective_timeout)
    return backend
