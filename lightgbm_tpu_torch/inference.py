"""The serving engine: the ensemble flattened once, then bucketed
microbatches through the traversal and margin kernels.

The counterpart of ``lightgbm_tpu/inference.py:540 PredictEngine``:

* **The bundle** (``predictor.py:SoABundle``) is built once: int32 node
  tables (and the packed node words where the ensemble fits their budget),
  float64 threshold tables and leaf values on the device.
* **Binning** stays ``torch.searchsorted`` in float64 against the float64
  tables, on the device, for every input: the threshold ranks, and so the
  leaves, are the JAX engine's whether or not a value is exact in float32.
  The JAX package's floor-to-f32 tables and its host-binned twin
  executable (``inference.py:705-736``) exist because a TPU lacks float64;
  the card has it.
* **One predict path, chosen by row count.**  Every prediction of the port
  (``Booster.predict``, leaf indices, early stopping, the server) goes
  through an engine.  An input of at most the largest bucket's rows is one
  microbatch: its rows are padded up to the smallest bucket that holds
  them, copied in once through the bucket's page-locked staging, binned,
  run through ``lgbt_traverse`` and ``lgbt_margin`` (``ops/traverse.py``)
  and copied out once, with no other host read.  A larger input runs in
  row passes of whole largest buckets (about ``ROWS_PER_PASS`` rows, the
  trees in passes of ``TREES_PER_PASS``: ``SoABundle._leaf_passes``)
  without staging.  Both give the same leaves and the same bits.
* **Buffer sets.**  Each engine owns one set of buffers a bucket
  (:class:`_BucketBuffers`), sized for its bundle once.
  :meth:`PredictEngine.prewarm` allocates every bucket's set off the
  serving path; a set that a dispatch has to allocate is counted in
  ``PredictEngine.dispatch_allocs``.  :func:`jit_entries` counts the sets
  alive in the process: the ``predict_jit_entries`` gauge.  A hot swap's
  new engine allocates its sets at its prewarm, before it serves, and the
  old engine's sets are freed with it.

Every dispatch lands a ``predict_dispatch`` counter (bucket, input path,
traversal, shape tag), and the bin, traverse and margin phases run under
:class:`~lightgbm_tpu_torch.utils.timer.PhaseTimers`.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import predictor as predictor_mod
from .config import parse_serving_buckets, resolve_device
from .obs import memory as obs_memory
from .obs.counters import counters as obs_counters
from .ops.traverse import margin, traverse
from .predictor import SoABundle
from .tree import Tree
from .utils import log
from .utils.timer import PhaseTimers

# default microbatch ladder (rows); the ``serving_buckets`` key overrides it
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 64, 512, 4096)

# the buffer sets alive in the process (the predict_jit_entries gauge)
_LIVE_SETS = [0]
_LIVE_LOCK = threading.Lock()


def _set_freed() -> None:
    with _LIVE_LOCK:
        _LIVE_SETS[0] -= 1


class _BucketBuffers:
    """One bucket's buffers of one engine: the device tensors of a
    microbatch (the used columns' rows in float64 ``[Fc, b]``, their int32
    ranks and categories and bool NaN and zero masks, the packed layout's
    int32 data words, the int32 leaves ``[T, b]`` and float64 scores ``[K,
    b]``) and, on a card, page-locked host staging for the rows, the
    scores and the leaves.  Allocated once, for one bundle and layout;
    ``lock`` is held for a whole microbatch."""

    def __init__(self, bundle: SoABundle, layout: str, rows: int):
        fc, t, k = bundle.num_cols, bundle.num_trees, bundle.num_class
        dev = bundle.device
        self.rows = rows
        self.lock = threading.Lock()
        empty = lambda s, dt: torch.zeros(s, dtype=dt, device=dev)
        self.dev: Dict[str, torch.Tensor] = {
            "x": empty((fc, rows), torch.float64),
            "bins": empty((fc, rows), torch.int32),
            "cats": empty((fc, rows), torch.int32),
            "nanm": empty((fc, rows), torch.bool),
            "zerom": empty((fc, rows), torch.bool),
            "leaf": empty((t, rows), torch.int32),
            "out": empty((k, rows), torch.float64)}
        if layout == "packed":
            self.dev["data"] = empty((fc, rows), torch.int32)
        staged = ("x", "leaf", "out")
        if dev.type == "cuda":
            self.host = {name: torch.zeros(self.dev[name].shape,
                                           dtype=self.dev[name].dtype,
                                           pin_memory=True)
                         for name in staged}
        else:                 # on the CPU the device buffers are the host's
            self.host = {name: self.dev[name] for name in staged}
        with _LIVE_LOCK:
            _LIVE_SETS[0] += 1
        weakref.finalize(self, _set_freed)

    def device_tensors(self) -> List[torch.Tensor]:
        return list(self.dev.values())


def jit_entries() -> int:
    """The ``predict_jit_entries`` gauge: the per-bucket buffer sets alive
    in this process, one per (engine, bucket).  The JAX package counts its
    compiled microbatch signatures here; the port compiles nothing per
    shape, and what a warmed engine must not do on its serving path is
    allocate.  A mixed-size replay over a warmed ladder leaves the gauge
    unmoved; a hot swap raises it by the new engine's ladder at its
    prewarm, before the swap, and lowers it again when the old engine is
    freed."""
    with _LIVE_LOCK:
        return _LIVE_SETS[0]


def _resolve(device) -> torch.device:
    if isinstance(device, torch.device):
        return device
    return resolve_device(device)


class PredictEngine:
    """The serving engine of a list of trees (``num_class`` a round) on
    ``device`` (``cuda`` unless the caller asks for ``cpu``; a missing
    card raises).  ``raw_scores`` is bit-identical to the JAX package's
    engine.

    ``backend``: ``auto`` and ``xla`` serve through the kernels (on the
    CPU, their plain versions); ``native`` serves margin requests from the
    host library's OpenMP predictor (``native.NativePredictor``) of
    ``model_str``, its raw margins the kernels' bit for bit (both add each
    class's trees oldest first in float64), and leaf indices still from
    the kernels.  Unlike the JAX engine's, ``auto`` never takes the host
    predictor (README "Parity notes").
    ``traversal``: ``xla`` (the node tables), ``packed`` (the node words;
    a bundle that has none degrades loudly to ``xla``) or ``auto``
    (``packed`` wherever the bundle has the words, else ``xla``).
    ``bundle`` is the trees' bundle when the caller already has it."""

    def __init__(self, trees: Sequence[Tree], num_class: int = 1,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prewarm: bool = False, backend: str = "auto",
                 model_str: Optional[str] = None,
                 traversal: str = "auto", device=None,
                 bundle: Optional[SoABundle] = None):
        if backend not in ("auto", "xla", "native"):
            raise ValueError(f"predict engine backend must be auto, xla, or "
                             f"native; got {backend!r}")
        self.device = _resolve(device)
        self._native = None
        if backend == "native":
            if model_str is None:
                raise ValueError("predict engine backend=native needs the "
                                 "model_str")
            from .native import NativePredictor
            self._native = NativePredictor(model_str=model_str)
        self.backend = "native" if self._native is not None else "xla"
        self.bundle = bundle if bundle is not None else SoABundle(
            list(trees), self.device, num_class)
        self.buckets = parse_serving_buckets(buckets)
        self.num_class = max(num_class, 1)
        self.timers = PhaseTimers()
        self._warmed = False
        if traversal not in ("auto", "xla", "packed"):
            raise ValueError(f"predict engine traversal must be auto, xla, "
                             f"or packed; got {traversal!r}")
        self.traversal = self._resolve_traversal(traversal)
        self._sets: Dict[int, _BucketBuffers] = {}
        self._sets_lock = threading.Lock()
        # buffer sets a dispatch allocated (none after a prewarm)
        self.dispatch_allocs = 0
        # the serving drift monitor (obs/model_quality.DriftMonitor),
        # attached by the ModelServer to its own engine when the model
        # carries a training distribution: every microbatch's binned rows
        # fold into it
        self.drift = None
        if prewarm:
            self.prewarm()

    def _resolve_traversal(self, want: str) -> str:
        """``serving_traversal``: an explicit ``packed`` on a bundle
        without node words degrades to ``xla`` with a ``layout_downgrade``
        event, never silently (``lightgbm_tpu/inference.py:586``);
        ``auto`` takes the node words wherever the bundle has them."""
        packable = self.bundle.packed
        if want == "packed" and not packable:
            log.warning("serving_traversal=packed unavailable "
                        "(categorical nodes or field widths past the "
                        "node-word budget); using the xla traversal")
            obs_counters.event(
                "layout_downgrade", stage="serving",
                requested="serving_traversal=packed", resolved="xla",
                reason="bundle not packable (categorical nodes or "
                       "field width)")
            return "xla"
        if want == "xla":
            return "xla"
        return "packed" if packable else "xla"

    # ------------------------------------------------------------- shapes

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def _bucket_rows(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_bucket

    def memory_prediction(self) -> Dict:
        """The serving term of ``obs/memory.py:predict_hbm`` for this
        bundle and ladder, which :meth:`preflight` holds to the budget."""
        b = self.bundle
        return obs_memory.predict_hbm(
            rows=0, features=0, bins=0, leaves=1,
            serving_trees=b.num_trees, serving_nodes=b.feat.shape[1],
            serving_cols=b.num_cols, serving_bins=b.num_bins,
            serving_buckets=self.buckets, serving_classes=b.num_class,
            serving_cat_rows=b.cat_mask.shape[0],
            serving_cat_width=b.cat_mask.shape[1], serving_packed=b.packed,
            serving_layout=self.traversal)

    def preflight(self, hbm_budget: float = 0.0) -> Dict:
        """Warn (or raise under an explicit ``hbm_budget``) before the
        buffers are allocated when the bundle and the buckets' buffers
        would oversubscribe the card."""
        return obs_memory.preflight(
            self.memory_prediction(), hbm_budget=hbm_budget,
            context="serving",
            capacity=obs_memory.device_capacity(self.device))

    def device_tensors(self) -> List[torch.Tensor]:
        """The bundle's tensors and the device buffers of this engine's
        allocated buckets."""
        return self.bundle.tensors() + [
            t for b in self.buckets if b in self._sets
            for t in self._sets[b].device_tensors()]

    def _buffers(self, rows: int, dispatch: bool) -> _BucketBuffers:
        """Bucket ``rows``'s buffer set, allocated on first use (counted
        in ``dispatch_allocs`` when a dispatch, not the prewarm, asks)."""
        bufs = self._sets.get(rows)
        if bufs is None:
            with self._sets_lock:
                bufs = self._sets.get(rows)
                if bufs is None:
                    bufs = _BucketBuffers(self.bundle, self.traversal, rows)
                    self._sets[rows] = bufs
                    self.dispatch_allocs += int(dispatch)
        return bufs

    # -------------------------------------------------------------- warmup

    def prewarm(self, hbm_budget: float = 0.0) -> "PredictEngine":
        """Allocate every bucket's buffers and run one microbatch of
        zeros through each, so that no request pays an allocation or the
        kernels' first load; no dispatch or drift is recorded."""
        self.preflight(hbm_budget)
        for b in self.buckets:
            bufs = self._buffers(b, dispatch=False)
            with bufs.lock:
                bufs.host["x"].zero_()
                self._microbatch(bufs, 0, self.bundle.num_trees, True)
        obs_counters.gauge("predict_jit_entries", jit_entries())
        self._warmed = True
        return self

    # ---------------------------------------------------------- microbatch

    def _microbatch(self, bufs: _BucketBuffers, n: int, total: int,
                    scores: bool) -> torch.Tensor:
        """Bin, traverse and (``scores``) sum the staged rows of ``bufs``
        on the device; returns the host tensor the result was copied into
        (float64 ``[K, b]`` scores, or int32 ``[T, b]`` leaves)."""
        bundle, dev = self.bundle, bufs.dev
        with self.timers.phase("predict_bin"):
            if self.device.type == "cuda":
                dev["x"].copy_(bufs.host["x"], non_blocking=True)
            bundle.bin_columns(dev["x"], dev["bins"], dev["cats"],
                               dev["nanm"], dev["zerom"], dev.get("data"))
            if self.drift is not None and n:
                self.drift.add_device_bins(dev["bins"][:, :n], n)
        with self.timers.phase("predict_traverse"):
            binned = ((dev["data"],) if self.traversal == "packed" else
                      (dev["bins"], dev["cats"], dev["nanm"], dev["zerom"]))
            leaf = traverse(binned, bundle.nodes(self.traversal,
                                                 slice(0, total)),
                            self.traversal, out=dev["leaf"][:total])
            if not scores:
                return self._copy_out(bufs, "leaf")
        with self.timers.phase("predict_margin"):
            dev["out"].zero_()
            margin(leaf, bundle.leaf_value[:total], self.num_class,
                   dev["out"])
            return self._copy_out(bufs, "out")

    def _copy_out(self, bufs: _BucketBuffers, name: str) -> torch.Tensor:
        """The microbatch's one copy out: device buffer ``name`` into its
        host staging, waited for."""
        if self.device.type == "cuda":
            bufs.host[name].copy_(bufs.dev[name], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        return bufs.host[name]

    def _run_bucket(self, xc: np.ndarray, total: int,
                    scores: bool) -> np.ndarray:
        """One microbatch of the rows ``xc`` (``[n, Fc]`` float64, the used
        columns, ``n`` at most the largest bucket), padded up the ladder:
        float64 ``[K, n]`` scores of the first ``total`` trees, or int32
        ``[T, n]`` leaves."""
        n = xc.shape[0]
        nb = self._bucket_rows(n)
        bufs = self._buffers(nb, dispatch=True)
        with bufs.lock:
            x = bufs.host["x"].numpy()
            x[:, :n] = xc.T
            x[:, n:] = 0.0
            res = self._microbatch(bufs, n, total, scores).numpy()
            out = (res[:, :n] if scores else res[:total, :n]).copy()
        self._dispatched(nb, "raw")
        return out

    def _dispatched(self, bucket: int, path: str) -> None:
        obs_counters.inc("predict_dispatch", bucket=bucket, path=path,
                         traversal=self.traversal,
                         exec=self.bundle.exec_id())
        obs_counters.gauge("predict_jit_entries", jit_entries())

    # -------------------------------------------------------------- passes

    def _pass_kw(self) -> Dict:
        """The row passes of an input larger than the largest bucket:
        whole largest buckets a pass, so that the drift windows close
        where the microbatches would close them; each pass's binned rows
        fold into the drift monitor bucket by bucket and count one
        ``predict_dispatch`` (``path=pass``, ``bucket`` its rows)."""
        mb = self.max_bucket
        drift = self.drift

        def on_pass(bins: torch.Tensor) -> None:
            rows = bins.shape[1]
            if drift is not None:
                for lo in range(0, rows, mb):
                    drift.add_device_bins(bins[:, lo:lo + mb],
                                          min(mb, rows - lo))
            self._dispatched(rows, "pass")
        return dict(layout=self.traversal, timers=self.timers,
                    on_pass=on_pass,
                    rows_per_pass=max(predictor_mod.ROWS_PER_PASS // mb, 1)
                    * mb)

    def _columns(self, X) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float64))
        cols = self.bundle.cols
        if len(cols) and X.shape[1] <= int(cols[-1]):
            log.fatal("predict engine: input has %d features but the model "
                      "splits on feature %d", X.shape[1], int(cols[-1]))
        return X[:, cols]

    # ------------------------------------------------------------- leaves

    def leaves(self, X: np.ndarray) -> np.ndarray:
        """Each tree's leaf index of every row, int32 ``[T, N]``."""
        xc = self._columns(X)
        t_count = self.bundle.num_trees
        if xc.shape[0] == 0:
            return np.zeros((t_count, 0), np.int32)
        if xc.shape[0] <= self.max_bucket:
            return self._run_bucket(xc, t_count, False)
        return self.bundle.pass_leaves(xc, **self._pass_kw())

    def binned_arrays(self, X: np.ndarray):
        """The device-binned rows ``(bins, cats, nanm, zerom)``, each
        ``[N, Fc]`` on the host: the rank space of the traversal."""
        x = self._columns(X)
        res = [np.zeros((x.shape[0], self.bundle.num_cols), dt)
               for dt in (np.int32, np.int32, bool, bool)]
        step = self.max_bucket
        for lo in range(0, x.shape[0], step):
            part = self.bundle.bin_used(x[lo:lo + step])
            for dst, a in zip(res, part):
                dst[lo:lo + a.shape[1]] = a.cpu().numpy().T
        return tuple(res)

    # ------------------------------------------------------------- scores

    def raw_scores(self, X: np.ndarray,
                   num_trees: int = -1) -> np.ndarray:
        """Raw scores ``[K, N]`` float64 of the first ``num_trees`` trees
        (all when negative or None): each tree's leaf value added to its
        class's score, trees oldest first, on the device
        (``lightgbm_tpu/inference.py:800``), bit for bit; one microbatch
        up to the largest bucket's rows, row passes above."""
        bundle = self.bundle
        total = (bundle.num_trees if num_trees is None or num_trees < 0
                 else min(num_trees, bundle.num_trees))
        if self._native is not None:
            return self._native_raw(X, total)
        xc = self._columns(X)
        if xc.shape[0] == 0:
            return np.zeros((self.num_class, 0), np.float64)
        if xc.shape[0] <= self.max_bucket:
            return self._run_bucket(xc, total, True)
        return bundle.pass_scores(xc, total, **self._pass_kw())

    def _native_raw(self, X, total: int) -> np.ndarray:
        """``backend="native"``: the host predictor's raw scores ``[K, N]``
        of the first ``total`` trees (whole iterations), one
        ``predict_dispatch`` (``path=native``); the drift monitor gets the
        rows binned on the device, in the rank space of the traversal
        (``lightgbm_tpu/inference.py:805-824``)."""
        x = np.atleast_2d(np.asarray(X, np.float64))
        with self.timers.phase("predict_traverse"):
            if self.drift is not None and len(self.bundle.cols) and len(x):
                bins = self.bundle.bin_used(self._columns(x))[0]
                self.drift.add_device_bins(bins, x.shape[0])
            out = self._native.predict(x, num_iteration=total //
                                       self.num_class, raw_score=True)
            out = (out[None, :] if out.ndim == 1
                   else np.ascontiguousarray(out.T))
        obs_counters.inc("predict_dispatch", bucket=x.shape[0],
                         path="native", exec=self.bundle.exec_id())
        return out
