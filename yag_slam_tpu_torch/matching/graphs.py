"""CUDA graphs of the matcher's device program.

``CorrelativeScanMatcher._run`` on a CUDA device goes through the process's
:data:`GRAPHS`.  Eager, one ``_run`` is some 570 small tensor ops, each
dispatched by the host, around three kernels; the card idles while the host
dispatches.  Here a dispatch is three steps:

1. staging: the host job arrays go to the card in one pinned, non-blocking
   copy into the entry's static input tensors (device tensors, as the
   chained pipeline passes, are copied on the card), and the scan library's
   rows are gathered into them with ``index_select(..., out=)``.  The
   gathers stay outside the graph because the library reallocates every
   field when it grows;
2. one replay of the captured ``_compute`` (world transform, grid build,
   coarse and fine passes, reductions);
3. a clone of the outputs, so that a result stays valid while the same
   graph runs again (a pipeline block, ``match_many_mega``'s chunks, a
   batch in flight).

An entry is keyed by the device, the dtype, the matcher's configuration,
its meta flag and the batch's shapes and flags, so every matcher of one
configuration in the process shares it (a fresh ``GraphSlam`` reuses the
graphs of the last one).  A key runs eagerly at its first use and is
captured at its second (:data:`CAPTURE_AT_USE`): keys used once cost no
capture, and the eager first run makes everything lazy (the kernel build,
the kernels' attribute and SM-count queries, the divisors of
``correlation.divisor``) happen outside any capture.  All graphs of a
device share one memory pool: they replay one at a time under the lock on
one stream, and each output is cloned right after its replay.

No copy in a dispatch blocks the host: the only wait is the caller's, for
the result.
"""
from __future__ import annotations

import math
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from yag_slam_tpu_torch.matching import kernels as K

# a key's use that captures its graph; the uses before it run eagerly
CAPTURE_AT_USE = 2

GraphKey = namedtuple("GraphKey", ["device", "dtype", "config", "meta", "N", "B",
                                   "P", "S", "penalty", "do_fine", "coarse_offset",
                                   "explicit"])

_NP = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_,
       torch.float32: np.float32, torch.float64: np.float64}

# the job arrays in the order _run takes them, then the explicit queries
_ARGS = ("idx", "mask", "pose", "q_idx", "center", "vp", "sub")
_QUERIES = ("qlx", "qly", "n_q")


class _Entry:
    """One key's static inputs (the dict ``_compute`` reads), and once
    captured its graph, the graph's outputs and the kernel launches of
    one replay."""

    def __init__(self, key, taps):
        N, B, P, dt, dev = key.N, key.B, key.P, key.dtype, key.device
        host = dict(idx=((N, B), torch.int64), mask=((N, B), torch.bool),
                    pose=((N, B, 3), dt), q_idx=((N,), torch.int64),
                    center=((N, 3), dt), vp=((N, 2), dt), sub=((N, 2), torch.int32))
        if key.explicit:
            host.update(qlx=((N, P), dt), qly=((N, P), dt), n_q=((N,), torch.int32))
        # the host-staged fields are views of one byte buffer, 8-byte aligned,
        # so one copy fills them all
        self.layout, off = {}, 0
        for name, (shape, dtype) in host.items():
            nbytes = math.prod(shape) * dtype.itemsize
            self.layout[name] = (off, nbytes, shape, dtype)
            off += -(-nbytes // 8) * 8
        self.buf = torch.empty(off, dtype=torch.uint8, device=dev)
        self.inputs = {name: self.buf[o:o + n].view(dtype).view(shape)
                       for name, (o, n, shape, dtype) in self.layout.items()}
        for name, dtype in dict(lx=dt, ly=dt, anchor=torch.int32, term=torch.int32,
                                has_run=torch.bool).items():
            self.inputs[name] = torch.empty((N, B, P), dtype=dtype, device=dev)
        if not key.explicit:
            self.inputs.update(qlx=torch.empty((N, P), dtype=dt, device=dev),
                               qly=torch.empty((N, P), dtype=dt, device=dev),
                               n_q=torch.empty((N,), dtype=torch.int32, device=dev))
        self.inputs["taps"] = taps.clone()
        self.explicit = key.explicit
        self.uses = 0
        self.graph = self.outputs = self.launches = None

    def stage(self, args, queries, lib):
        """Write one dispatch's inputs into the static tensors, on the
        current stream, without waiting for the card."""
        items = list(zip(_ARGS, args))
        if self.explicit:
            items += list(zip(_QUERIES, queries))
        host = [(name, a) for name, a in items if not isinstance(a, torch.Tensor)]
        if host:
            pinned = self.buf.device.type == "cuda"
            staging = torch.empty(self.buf.numel(), dtype=torch.uint8, pin_memory=pinned)
            view = staging.numpy()
            for name, a in host:
                off, nbytes, shape, dtype = self.layout[name]
                if np.shape(a) != shape:
                    raise ValueError(f"{name}: expected shape {shape}, got {np.shape(a)}")
                view[off:off + nbytes].view(_NP[dtype]).reshape(shape)[...] = a
            # the caching host allocator keeps the pinned block until the copy ran
            self.buf.copy_(staging, non_blocking=pinned)
        for name, a in items:
            if isinstance(a, torch.Tensor):
                self.inputs[name].copy_(a)
        st = self.inputs
        N, B, P = st["lx"].shape
        flat = st["idx"].view(-1)
        for k in ("lx", "ly", "anchor", "term", "has_run"):
            torch.index_select(lib[k], 0, flat, out=st[k].view(N * B, P))
        if not self.explicit:
            for src, dst in (("lx", "qlx"), ("ly", "qly"), ("n", "n_q")):
                torch.index_select(lib[src], 0, st["q_idx"], out=st[dst])


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` captured on a side stream into a shared
    memory pool.  Unlike ``torch.cuda.graph``, the capture neither
    synchronizes the card nor empties the allocator's caches."""

    def __init__(self, pool, stream):
        self._pool, self._stream = pool, stream
        self._graph = torch.cuda.CUDAGraph()

    def capture(self, fn):
        """Capture fn()'s device work; returns fn()'s outputs, which the
        replays overwrite."""
        with torch.cuda.stream(self._stream):
            # thread_local: work that other threads launch meanwhile (on
            # other streams) does not invalidate this capture
            self._graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                return fn()
            finally:
                self._graph.capture_end()

    def replay(self):
        self._graph.replay()


class GraphCache:
    """Per key, static inputs and the CUDA graph of ``_compute`` over
    them (see the module docstring).  `graph`, a callable taking the
    device and returning an object with ``capture(fn)`` and ``replay()``,
    replaces :class:`CudaGraph` (the CPU tests pass a stand-in)."""

    def __init__(self, graph=None):
        self._graph = graph
        self._lock = threading.Lock()
        self._entries = {}
        self._pools = {}
        # host seconds of the captures, and the dispatches by kind
        self.stats = dict(eager=0, captures=0, capture_s=0.0, replays=0)

    @staticmethod
    def key(m, args, P, penalty, do_fine, coarse_offset, S, queries=None):
        N, B = args[0].shape
        return GraphKey(m.device, m.dtype, m.config, m.return_meta, int(N), int(B),
                        int(P), int(S), bool(penalty), bool(do_fine),
                        float(coarse_offset), queries is not None)

    def entry(self, key):
        """The entry of `key` (None before its first use)."""
        return self._entries.get(key)

    def _new_graph(self, device):
        if self._graph is not None:
            return self._graph(device)
        if device not in self._pools:
            with torch.cuda.device(device):
                self._pools[device] = (torch.cuda.graph_pool_handle(),
                                       torch.cuda.Stream(device))
        return CudaGraph(*self._pools[device])

    def run(self, m, args, P, penalty, do_fine, coarse_offset, S, queries=None):
        """``m._run`` through the key's entry: stage, then run ``_compute``
        eagerly (first use), or capture it (second use) and replay.
        Returns fresh (packed, grid0) tensors."""
        key = self.key(m, args, P, penalty, do_fine, coarse_offset, S, queries)
        # one lock from staging to the clone: two threads never interleave
        # staging and replay of one entry, and one capture runs at a time
        with self._lock:
            lib = m.library.fields
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _Entry(key, m._taps)
            e.stage(args, queries, lib)
            e.uses += 1
            if e.graph is None:
                def body():
                    return m._compute(e.inputs, S, penalty, do_fine, coarse_offset)

                if e.uses < CAPTURE_AT_USE:
                    self.stats["eager"] += 1
                    return body()
                t0 = time.perf_counter()
                graph = self._new_graph(key.device)
                with K.captured_launches() as counts:
                    outputs = graph.capture(body)
                e.graph, e.outputs, e.launches = graph, outputs, counts
                self.stats["captures"] += 1
                self.stats["capture_s"] += time.perf_counter() - t0
            e.graph.replay()
            K.add_launches(e.launches)
            self.stats["replays"] += 1
            packed, grid0 = e.outputs
            return packed.clone(), None if grid0 is None else grid0.clone()


# the process's graphs: shared by every matcher, as JAX's jit cache is
GRAPHS = GraphCache()
