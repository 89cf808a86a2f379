"""The (batch, feature) device mesh of the data-parallel learner.

The port of the subset of ``lightgbm_tpu/parallel/mesh.py`` that the
GSPMD learner and the streamed grower use: the axis names (:20-26),
``make_named_mesh`` (:65), ``MeshPlanError`` (:90),
``default_chunk_rows`` (:244), ``parse_mesh_shape`` (:377) and
``pad_rows`` (:609); the memory-driven planner (``MeshPlan``,
``plan_mesh``, :98-228) and the placement walk (``PlacementPlan``,
``resolve_placement``, :231-374), costed by the port's memory model
(``obs/memory.py``); and the bring-up of a training over several
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
slots, the same shape on every rank: its part of the global mesh that
``mesh_shape`` names over every process's slots, as the JAX package
names it over every process's devices (:func:`global_mesh_shape`,
:func:`local_extents`).  Its slots start at card
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
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..obs import memory
from ..utils import log
from . import sync

# GSPMD mesh axes: rows shard over ``batch``, the histogram pool over
# ``feature``
BATCH_AXIS = "batch"
FEATURE_AXIS = "feature"


class MeshPlanError(RuntimeError):
    """A mesh shape that the available slots cannot serve, or no mesh
    shape or placement whose predicted peak fits the budget (the message
    names the best candidate's largest components)."""


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


def global_mesh_shape(spec: str, local_slots: int, procs: int):
    """``mesh_shape`` over ``procs`` processes of ``local_slots`` slots
    each, read as the JAX package reads it (``lightgbm_tpu/boosting.py:
    887-912``): the global ``(data, feature)`` extents over every
    process's slots, or None for ``auto``.  Raises ValueError when the
    slots cannot serve the shape (:func:`parse_mesh_shape`) and
    :class:`MeshPlanError` with :func:`mesh_shape_fits_processes`'s words
    when it does not lay out over the processes."""
    explicit = parse_mesh_shape(spec, local_slots * procs)
    if explicit is not None and procs > 1:
        refusal = mesh_shape_fits_processes(explicit[0], explicit[1], procs,
                                            local_slots)
        if refusal is not None:
            raise MeshPlanError(f"mesh_shape={spec} cannot serve {procs}-"
                                f"process training: {refusal}")
    return explicit


def local_extents(data: int, feature: int, procs: int,
                  axis: str = BATCH_AXIS) -> Tuple[int, int]:
    """The ``(data, feature)`` mesh of one process's slots in a global
    ``data x feature`` mesh over ``procs`` processes that extend ``axis``
    (the batch axis: each process holds whole batch rows of its own; the
    feature axis: every row, and its own column slices)."""
    procs = max(1, int(procs))
    if axis == FEATURE_AXIS:
        return data, feature // procs
    return data // procs, feature


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


# ---- the memory-driven planner (lightgbm_tpu/parallel/mesh.py:98-374) ----
#
# Both walks take their cost from the port's memory model through this
# module attribute, which a test may replace by another cost function of
# the same keywords (the JAX package's, in tests/test_torch_planner.py).
predict_hbm = memory.predict_hbm


class MeshPlan(NamedTuple):
    """One planner decision (:func:`plan_mesh`, :98): mesh extents,
    whether the bin matrix is block-sharded over ``feature`` (each slot
    holding only its column slice of its batch shard) or replicated along
    it, and the evidence backing the choice."""
    data: int                  # batch-axis extent
    feature: int               # feature-axis extent
    block_shard_bins: bool     # bins cut over both axes vs over batch
    per_device_bytes: int      # predicted peak of the busiest card
    capacity: Optional[int]    # budget the plan was judged against
    components: dict           # top components {name: bytes}
    reason: str                # human-readable decision trail


def _mesh_factorizations(n: int):
    """(data, feature) candidates over exactly ``n`` slots, data-major
    first (:111)."""
    return [(d, n // d) for d in range(n, 0, -1) if n % d == 0]


def mesh_shape_fits_processes(data: int, feature: int, procs: int,
                              local_devices: int) -> Optional[str]:
    """Whether a ``(data, feature)`` mesh lays out so that every process's
    local slots tile whole batch rows (:119): None when it does, else the
    refusal."""
    procs = max(1, int(procs))
    if procs == 1:
        return None
    if data % procs != 0:
        return (f"batch extent {data} does not divide over {procs} "
                "processes (each rank's row partition needs whole "
                "batch-axis rows)")
    if local_devices and local_devices % feature != 0:
        return (f"{local_devices} local device(s) per process cannot "
                f"tile {feature} feature shard(s) per batch row")
    return None


def plan_mesh(n_devices: int, rows: int, features: int, bins: int = 255,
              leaves: int = 31, num_class: int = 1,
              bin_bytes: Optional[int] = None, packed_cols: int = 0,
              valid_rows: int = 0, capacity: Optional[int] = None,
              prefer: str = "data", procs: int = 1, local_devices: int = 0,
              **model) -> MeshPlan:
    """The memory-driven planner (``mesh_shape=auto``, :141-228): the
    first ``(data, feature)`` factorization of ``n_devices`` slots, in
    order of preference, whose predicted peak fits ``capacity``.
    ``prefer="data"`` walks from pure data-parallel toward feature-heavy
    shapes, ``"feature"`` the other way, ``"square"`` from the most
    balanced; each shape is tried with the bins replicated along
    ``feature`` first and block-sharded only if that does not fit.  With
    no capacity (the CPU) the preferred shape wins.  Over several
    processes, shapes that would split a rank's rows across processes are
    skipped.  ``model`` goes to the cost function as it is (the port's
    layout: ``slots_per_card``, ``voting``, ...).  Raises
    :class:`MeshPlanError` when nothing fits."""
    n_devices = max(int(n_devices), 1)
    cands = _mesh_factorizations(n_devices)
    if procs > 1:
        fits = [(d, f) for d, f in cands
                if mesh_shape_fits_processes(d, f, procs,
                                             local_devices) is None]
        if not fits:
            raise MeshPlanError(
                f"no factorization of {n_devices} device(s) lays out over "
                f"{procs} processes x {local_devices or '?'} local "
                "device(s): every candidate leaves some rank's row "
                "partition straddling another process's devices")
        cands = fits
    if prefer == "feature":
        cands = cands[::-1]
    elif prefer == "square":
        cands.sort(key=lambda df: (abs(df[0] - df[1]), -df[0]))

    best = None            # smallest-peak candidate, for the error message
    for d, f in cands:
        for block in (False, True) if f > 1 else (False,):
            p = predict_hbm(rows=rows, features=features, bins=bins,
                            leaves=leaves, num_class=num_class,
                            bin_bytes=bin_bytes, packed_cols=packed_cols,
                            valid_rows=valid_rows, data_shards=d,
                            feature_shards=f, block_shard_bins=block,
                            **model)
            peak, comps = int(p["peak_bytes"]), memory.top_terms(p, 4)
            if best is None or peak < best[3]:
                best = (d, f, block, peak, comps)
            if capacity is None or peak <= capacity:
                why = (f"{d}x{f} mesh"
                       + (", bins block-sharded" if block
                          else (", bins replicated over feature"
                                if f > 1 else ""))
                       + (f": predicted per-device peak "
                          f"{peak / 1e9:.2f} GB fits capacity "
                          f"{capacity / 1e9:.2f} GB"
                          if capacity is not None else
                          ": no capacity signal, preferred shape"))
                return MeshPlan(d, f, block, peak, capacity, comps, why)
    d, f, block, peak, comps = best
    detail = ", ".join(f"{k}={v / 1e9:.2f} GB" for k, v in comps.items())
    raise MeshPlanError(
        f"no mesh shape over {n_devices} device(s) fits: best candidate "
        f"{d}x{f}{' (bins block-sharded)' if block else ''} still needs "
        f"{peak / 1e9:.2f} GB per device vs capacity "
        f"{(capacity or 0) / 1e9:.2f} GB (top components: {detail}) — "
        f"shrink the shape (num_leaves/max_bin/rows), add devices, or "
        f"raise hbm_budget")


class PlacementPlan(NamedTuple):
    """One data-placement decision (:func:`resolve_placement`, :231):
    where the bin matrix lives for this run and the evidence backing the
    choice."""
    mode: str                  # resident | chunked | sharded
    chunk_rows: int            # streamed block size (0 unless chunked)
    mesh: Optional[MeshPlan]   # the mesh plan when mode == "sharded"
    peak_bytes: int            # predicted peak at the chosen placement
    capacity: Optional[int]    # budget the plan was judged against
    components: dict           # top predicted components {name: bytes}
    reason: str                # human-readable decision trail


# the smallest block the chunked rung halves down to (:327)
MIN_CHUNK_ROWS = 4096


def resolve_placement(rows: int, features: int, bins: int = 255,
                      leaves: int = 31, num_class: int = 1,
                      bin_bytes: Optional[int] = None,
                      packed_cols: int = 0, valid_rows: int = 0,
                      capacity: Optional[int] = None,
                      data_stream: str = "auto",
                      stream_chunk_rows: int = 0,
                      n_devices: int = 1, prefer: str = "data",
                      procs: int = 1, local_devices: int = 0,
                      mesh_model: Optional[dict] = None,
                      **model) -> PlacementPlan:
    """The capacity walk (``data_stream=auto``, :255-374): where the bin
    matrix lives, decided before it is copied to the card, by the
    predicted peak of each rung in turn:

    1. **resident**: the whole matrix on the card;
    2. **chunked**: streamed row blocks (``data/stream.py``), the
       requested (or default) block size first, then halving blocks down
       to :data:`MIN_CHUNK_ROWS`;
    3. **sharded**: the shape :func:`plan_mesh` finds over ``n_devices``
       slots, when there are more than one.

    ``data_stream=resident`` or ``chunked`` pins its rung (the pre-flight
    still holds it to the budget later); an explicit
    ``stream_chunk_rows`` pins the chunked rung's block size.  ``model``
    goes to the cost function on every rung, ``mesh_model`` besides it on
    the sharded rung.  Raises :class:`MeshPlanError` naming the best
    candidate of each rung when nothing fits."""

    def predict(chunk):
        p = predict_hbm(rows=rows, features=features, bins=bins,
                        leaves=leaves, num_class=num_class,
                        bin_bytes=bin_bytes, packed_cols=packed_cols,
                        valid_rows=valid_rows, stream_chunk_rows=chunk,
                        **model)
        return int(p["peak_bytes"]), memory.top_terms(p, 4)

    def decide(plan: PlacementPlan) -> PlacementPlan:
        log.info("Placement: %s (%s)", plan.mode, plan.reason)
        return plan

    res_peak, res_comps = predict(0)
    if data_stream == "resident":
        return decide(PlacementPlan(
            "resident", 0, None, res_peak, capacity, res_comps,
            "data_stream=resident pinned by config"))
    if data_stream == "auto" and (capacity is None
                                  or res_peak <= capacity):
        why = ("resident: no capacity signal" if capacity is None else
               f"resident: predicted peak {res_peak / 1e9:.2f} GB fits "
               f"capacity {capacity / 1e9:.2f} GB")
        return decide(PlacementPlan("resident", 0, None, res_peak,
                                    capacity, res_comps, why))

    forced_chunk = data_stream == "chunked"
    best_stream = None
    chunk = default_chunk_rows(rows, stream_chunk_rows)
    while True:
        peak, comps = predict(chunk)
        if best_stream is None or peak < best_stream[1]:
            best_stream = (chunk, peak, comps)
        if forced_chunk and stream_chunk_rows:
            # an explicit block size is a pin, not a starting point
            break
        if capacity is not None and peak > capacity \
                and chunk > MIN_CHUNK_ROWS:
            chunk = max(MIN_CHUNK_ROWS, chunk // 2)
            continue
        break
    chunk, peak, comps = best_stream
    if forced_chunk or capacity is None or peak <= capacity:
        why = (f"chunked: {chunk}-row blocks, predicted peak "
               f"{peak / 1e9:.2f} GB"
               + (" pinned by data_stream=chunked" if forced_chunk else
                  (f" fits capacity {capacity / 1e9:.2f} GB (resident "
                   f"needs {res_peak / 1e9:.2f} GB)"
                   if capacity is not None else "")))
        return decide(PlacementPlan("chunked", chunk, None, peak,
                                    capacity, comps, why))

    if n_devices > 1:
        try:
            mp = plan_mesh(n_devices, rows, features, bins=bins,
                           leaves=leaves, num_class=num_class,
                           bin_bytes=bin_bytes, packed_cols=packed_cols,
                           valid_rows=valid_rows, capacity=capacity,
                           prefer=prefer, procs=procs,
                           local_devices=local_devices,
                           **{**model, **(mesh_model or {})})
        except MeshPlanError:
            mp = None
        if mp is not None:
            return decide(PlacementPlan(
                "sharded", 0, mp, mp.per_device_bytes, capacity,
                mp.components,
                f"sharded: {mp.reason} (resident needs "
                f"{res_peak / 1e9:.2f} GB, best streamed "
                f"{peak / 1e9:.2f} GB)"))

    detail = ", ".join(f"{k}={v / 1e9:.2f} GB" for k, v in comps.items())
    raise MeshPlanError(
        f"no data placement fits capacity "
        f"{(capacity or 0) / 1e9:.2f} GB: resident needs "
        f"{res_peak / 1e9:.2f} GB, best streamed candidate "
        f"({chunk}-row blocks) still needs {peak / 1e9:.2f} GB "
        f"(top components: {detail})"
        + ("" if n_devices > 1 else ", and only 1 device is available "
           "for sharding") +
        " — shrink the shape (num_leaves/max_bin), lower "
        "stream_chunk_rows, add devices, or raise hbm_budget")


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


def write_machine_list(path: str, machines) -> None:
    """Inverse of :func:`parse_machine_list` (:494): the supervisor's
    shrink drops an evicted rank's entry."""
    with open(path, "w") as f:
        for ip, port in machines:
            f.write(f"{ip} {port}\n")


def refresh_local_ports(path: str) -> None:
    """Point every loopback entry of a machine list at a port just bound
    and released (:502): a group relaunched on one host reuses its list,
    and the dead group's ports may linger.  Other entries stay."""
    out = []
    for ip, port in parse_machine_list(path):
        if ip in ("127.0.0.1", "localhost"):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
        out.append(f"{ip} {port}\n")
    with open(path, "w") as f:
        f.write("".join(out))


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
    process a second call returns the running group's backend.

    The rendezvous is fenced (:567-578): when a supervisor has stamped the
    group's incarnation epoch beside ``output_model``
    (``checkpoint.group_epoch_path``) and it is newer than the epoch this
    process was launched under, the process is a straggler of a dead
    incarnation and raises :class:`~.sync.StaleEpochError` before it
    touches the rendezvous."""
    if cfg.num_machines <= 1:
        return None
    from ..checkpoint import group_epoch, read_group_epoch_file
    mine = group_epoch()
    stamped = read_group_epoch_file(cfg.output_model)
    if stamped is not None and stamped > mine:
        from ..obs.counters import counters
        counters.event("stale_epoch_rejected", op="distributed_init",
                       frame_epoch=mine, group_epoch=stamped)
        raise sync.StaleEpochError(
            f"startup barrier refused: this process was launched under "
            f"epoch {mine} but the group is at epoch {stamped} — a stale "
            f"incarnation must not join the new rendezvous",
            frame_epoch=mine, group_epoch=stamped)
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
