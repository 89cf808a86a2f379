"""Collective-traffic accounting (``lightgbm_tpu/obs/collectives.py``).

* :func:`note_collective`: the one home of the port's collective counts.
  Every host-object collective of :mod:`..parallel.sync` is counted here,
  into the ``collective_calls`` / ``collective_bytes`` counters of
  :mod:`.counters`, tagged by operation and site; the flight recorder's
  progress records read their :func:`totals`.
* :func:`intercept`: wraps ``torch.distributed``'s ``all_reduce``,
  ``all_gather`` and ``broadcast`` for a block (where the JAX package
  wraps ``lax.psum`` and the rest) and collects one record a call with the
  caller's site and whether it came from a split step.

The JAX package's ``hlo_census`` reads the collectives XLA inserts into a
compiled executable; the port issues every collective itself, so there is
nothing to census and it is not ported.
"""
from __future__ import annotations

import contextlib
import os
import traceback
from typing import Any, Dict, List, Optional

INTERCEPTED_OPS = ("all_reduce", "all_gather", "broadcast")


def tree_nbytes(tree: Any) -> int:
    """Payload bytes of a tensor, an array, a byte string, or a nesting of
    them in tuples, lists and dicts."""
    if isinstance(tree, (bytes, bytearray, memoryview)):
        return len(tree)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    numel = getattr(tree, "numel", None)
    if callable(numel) and hasattr(tree, "element_size"):   # a tensor
        return int(numel()) * int(tree.element_size())
    nbytes = getattr(tree, "nbytes", None)
    if isinstance(nbytes, int):                             # an array
        return nbytes
    return 0


def classify_site(stack=None):
    """``(site, per_split)`` for the innermost frame of the port outside
    ``obs/``: ``per_split`` when a split step (a frame named ``step`` in
    ``grower.py`` or ``parallel/gspmd.py``) is on the stack, as the JAX
    package classifies collectives of its grow loop's body."""
    if stack is None:
        stack = traceback.extract_stack()
    obs_dir = os.sep + "obs" + os.sep
    site = next((f"{os.path.basename(f.filename)}:{f.lineno}"
                 for f in reversed(stack)
                 if "lightgbm_tpu_torch" in f.filename
                 and obs_dir not in f.filename), "?")
    per_split = any(f.name == "step"
                    and os.path.basename(f.filename) in ("grower.py",
                                                         "gspmd.py")
                    for f in stack)
    return site, per_split


def note_collective(op: str, value: Any, axis: Any, site: str) -> None:
    """Count one collective and its payload bytes into the counters."""
    from .counters import counters
    nb = tree_nbytes(value)
    counters.inc("collective_calls", op=op, site=site)
    counters.inc("collective_bytes", value=nb, op=op, site=site)


def totals() -> Dict[str, int]:
    """The collective traffic this process has counted so far, as
    ``{"calls", "bytes"}``: what each progress record carries."""
    from .counters import counters
    return {"calls": int(counters.total("collective_calls")),
            "bytes": int(counters.total("collective_bytes"))}


@contextlib.contextmanager
def intercept(records: Optional[List[Dict[str, Any]]] = None,
              count: bool = False):
    """Wrap ``torch.distributed``'s tensor collectives for the block.
    Yields the record list; each call appends ``{"op", "bytes", "axis",
    "site", "per_split"}`` (``axis`` names the group, "default" for the
    default one); ``count=True`` also counts it (:func:`note_collective`)."""
    import torch.distributed as dist
    out: List[Dict[str, Any]] = [] if records is None else records
    orig = {}

    def wrap(name):
        fn = getattr(dist, name)
        orig[name] = fn

        def inner(tensor, *args, **kw):
            site, per_split = classify_site()
            group = kw.get("group")
            axis = "default" if group is None else str(group)
            out.append({"op": name, "bytes": tree_nbytes(tensor),
                        "axis": axis, "site": site, "per_split": per_split})
            if count:
                note_collective(name, tensor, axis, site)
            return fn(tensor, *args, **kw)
        return inner

    for name in INTERCEPTED_OPS:
        setattr(dist, name, wrap(name))
    try:
        yield out
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)
