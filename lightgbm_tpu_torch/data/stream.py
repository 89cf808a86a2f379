"""Streamed out-of-core training data (``data_stream=chunked``): the bin
matrix kept on the host as row blocks, and the double-buffered pipeline
that moves them through the card one block at a time.

The port of ``lightgbm_tpu/data/stream.py``: :class:`HostBlockStore`
(:42) and :class:`BlockStreamer` (:85).  A histogram is a sum over row
blocks, so the bins need never lie on the card whole: each split's pass
copies every block in, routes and measures it, and lets it go.  What
differs from the JAX package:

* blocks are plain row slices of the matrix; the last one is simply
  shorter.  The JAX store pads its tail block and masks it with a
  ``valid`` count because XLA compiles one static block shape; the
  port's kernels take any row count;
* on a card the matrix lies in page-locked memory
  (:func:`pin_matrix`, which the dataset keeps in place of its pageable
  copy, so the host holds the matrix once).  A ``non_blocking`` copy
  from pageable memory runs synchronously, and the double buffer would
  overlap nothing;
* the pipeline is CUDA streams and events instead of an asynchronous
  ``device_put``: two device buffers of ``chunk_rows x F`` made once, a
  side stream that copies, block k+1's copy started before block k's
  kernels are, the compute stream waiting on block k's copy event, and
  the copy into a buffer waiting on the event recorded after the last
  kernel that read it.  Nothing in a pass waits on the host.

**Waits** (``stream_wait_ms``, :meth:`BlockStreamer.take_wait_ms`): the
JAX package times the host's wait for each block.  Here the host never
waits; the compute stream does, on the copy event.  With ``timed`` set
(the flight recorder armed), a pair of timing events brackets each of
those waits on the compute stream, and :meth:`take_wait_ms` sums their
elapsed times after the tree's host read has passed them: the card's
time stalled on the link, read without a wait of its own.  A block whose
wait passes :data:`STALL_THRESHOLD_MS` counts as a ``stream_stall``.

uint16 bins move through their int16 view (``ops/histogram.py:movable``).
On the CPU the streamer hands out the host slices themselves.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..ops.histogram import movable
from ..obs.counters import counters
from ..utils import log

# a block's wait past this is a stall (lightgbm_tpu/data/stream.py:40)
STALL_THRESHOLD_MS = 1.0


def pin_matrix(binned: np.ndarray) -> np.ndarray:
    """``binned`` copied once into page-locked host memory: the returned
    array is a view of a pinned tensor, which it keeps alive.  A matrix
    that is page-locked already comes back as it is."""
    src = torch.from_numpy(np.ascontiguousarray(binned))
    if src.is_pinned():
        return binned
    pinned = torch.empty(src.shape, dtype=movable(src).dtype,
                         pin_memory=True)
    pinned.copy_(movable(src))
    return pinned.numpy().view(binned.dtype)


class HostBlockStore:
    """The binned ``[N, F]`` matrix as host row blocks of ``chunk_rows``
    rows (clamped to ``[1, N]``); block k is rows ``bounds(k)``, a view,
    and the last block holds what is left."""

    def __init__(self, binned: np.ndarray, chunk_rows: int):
        if binned.ndim != 2:
            raise ValueError("HostBlockStore needs a [N, F] binned matrix")
        n, f = binned.shape
        self.matrix = np.ascontiguousarray(binned)
        self.num_rows, self.num_cols = n, f
        self.chunk_rows = max(1, min(int(chunk_rows), n))
        self.num_blocks = -(-n // self.chunk_rows)
        self.nbytes = int(self.matrix.nbytes)

    def bounds(self, k: int) -> Tuple[int, int]:
        """Rows ``[lo, hi)`` of block ``k``."""
        lo = k * self.chunk_rows
        return lo, min(lo + self.chunk_rows, self.num_rows)

    def block_rows(self) -> List[int]:
        """Every block's rows, in order."""
        return [hi - lo for lo, hi in map(self.bounds,
                                          range(self.num_blocks))]


class BlockStreamer:
    """One pass over a :class:`HostBlockStore` on ``device`` is
    :meth:`blocks`; made once per training, it holds the two device
    buffers, the copy stream and the events of the pipeline (module
    docstring) and counts the blocks and bytes it streamed."""

    def __init__(self, store: HostBlockStore, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.store, self.device = store, dev
        self.blocks_streamed = self.bytes_streamed = self.passes = 0
        # the waits' timing (module docstring): off unless asked for
        self.timed = False
        self._wait_ev: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._waits = 0          # pairs recorded since the last take
        host = torch.from_numpy(store.matrix)
        self.dtype = host.dtype
        bounds = [store.bounds(k) for k in range(store.num_blocks)]
        # each block's host slice and, on a card, the buffer rows it goes
        # to, made once: a pass of many blocks is host-bound
        self._src = [movable(host)[lo:hi] for lo, hi in bounds]
        self._out = [s.view(self.dtype) for s in self._src]
        if dev.type != "cuda":
            return
        if not movable(host).is_pinned():
            raise ValueError("BlockStreamer: the matrix must lie in "
                             "page-locked memory (data/stream.py:"
                             "pin_matrix) to stream to a card")
        shape = (store.chunk_rows, store.num_cols)
        bufs = [torch.empty(shape, dtype=movable(host).dtype, device=dev)
                for _ in range(2)]
        self._dst = [bufs[k % 2][:hi - lo] for k, (lo, hi) in
                     enumerate(bounds)]
        self._out = [d.view(self.dtype) for d in self._dst]
        self._copy = torch.cuda.Stream(dev)
        self._copied = [torch.cuda.Event() for _ in range(2)]
        self._consumed = [torch.cuda.Event() for _ in range(2)]

    def _copy_in(self, k: int) -> None:
        """Block k's copy into buffer k % 2 on the copy stream, after the
        last kernel that read that buffer."""
        b = k % 2
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(self._consumed[b])
            self._dst[k].copy_(self._src[k], non_blocking=True)
            self._copied[b].record(self._copy)

    def blocks(self) -> Iterator[Tuple[int, int, int, torch.Tensor]]:
        """One full pass over the store, in block order: ``(k, lo, hi,
        block)`` with ``block`` the ``[hi - lo, F]`` bins of rows
        ``[lo, hi)``, in the matrix's type, on the device.  On a card the
        caller launches block k's kernels on the current stream before it
        asks for the next block; the buffer is reused two blocks later."""
        store = self.store
        nb = store.num_blocks
        cuda = self.device.type == "cuda"
        if cuda:
            cur = torch.cuda.current_stream(self.device)
            self._copy_in(0)
        for k in range(nb):
            block = self._out[k]
            self.blocks_streamed += 1
            self.bytes_streamed += block.numel() * block.element_size()
            if cuda:
                if self.timed:
                    if self._waits == len(self._wait_ev):
                        self._wait_ev.append(
                            (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True)))
                    pair = self._wait_ev[self._waits]
                    self._waits += 1
                    pair[0].record(cur)
                cur.wait_event(self._copied[k % 2])
                if self.timed:
                    pair[1].record(cur)
                # started as late as it may be, so that block k's first
                # kernel follows it closely: a copy overlaps the kernels
                # that are launched while it runs
                if k + 1 < nb:
                    self._copy_in(k + 1)
            yield (k, *store.bounds(k), block)
            if cuda:
                self._consumed[k % 2].record(cur)
        self.passes += 1

    def take_wait_ms(self) -> float:
        """The compute stream's waits on the copies since the last take,
        in ms (0 off a card or untimed), each block's counted into
        ``stream_wait_ms`` and, past :data:`STALL_THRESHOLD_MS`, into
        ``stream_stalls`` with a ``stream_stall`` event.  Called after the
        tree's host read, when every recorded event has completed."""
        total = 0.0
        for k in range(self._waits):
            a, b = self._wait_ev[k]
            ms = a.elapsed_time(b)
            total += ms
            if ms > STALL_THRESHOLD_MS:
                counters.inc("stream_stalls")
                counters.event("stream_stall",
                               block=k % max(1, self.store.num_blocks),
                               wait_ms=round(ms, 3),
                               pass_index=self.passes,
                               chunk_rows=self.store.chunk_rows)
        self._waits = 0
        if total:
            counters.inc("stream_wait_ms", total)
        return total


def make_block_store(binned: np.ndarray, chunk_rows: int) -> HostBlockStore:
    """The host block store, with the pipeline's shape logged once."""
    store = HostBlockStore(binned, chunk_rows)
    log.info("Streamed data pipeline: %d rows x %d cols in %d block(s) of "
             "%d rows (%.1f MB a block, double-buffered)", store.num_rows,
             store.num_cols, store.num_blocks, store.chunk_rows,
             store.chunk_rows * store.num_cols
             * store.matrix.dtype.itemsize / 1e6)
    return store
