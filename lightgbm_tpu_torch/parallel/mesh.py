"""The (batch, feature) device mesh of the data-parallel learner.

The port of the subset of ``lightgbm_tpu/parallel/mesh.py`` that the
GSPMD learner uses: the axis names (:20-26), ``make_named_mesh`` (:65),
``MeshPlanError`` (:90), ``parse_mesh_shape`` (:377) and ``pad_rows``
(:609).  A :class:`Mesh` is a
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
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils import log

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
    """The mesh slots for ``device``'s type (module docstring)."""
    if device.type == "cpu":
        return [torch.device("cpu")] * max(1, mesh_devices)
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("no CUDA card is visible for the mesh")
    k = mesh_devices or cards
    if k > cards:
        log.warning("mesh_devices=%d over %d visible card(s): %d mesh "
                    "slots share each card", k, cards, -(-k // cards))
    return [torch.device("cuda", s % cards) for s in range(k)]


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


def pad_rows(n: int, shards: int) -> int:
    """Rows padded so every shard gets an equal slice."""
    return (-n) % shards
