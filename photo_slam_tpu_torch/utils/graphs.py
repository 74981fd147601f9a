"""Captured CUDA graphs: the port's counterpart of jax.jit.

A `GraphCache` holds the captured `torch.cuda.CUDAGraph`s of one owner (the
render service, one map's StepGraphs), keyed as jit's static arguments are:
the caller's key (the render settings, flags), the shapes, dtypes and
device of the inputs, the addresses of the resident tensors, and the
float32 math flags (TF32), which a graph freezes. It is an
LRU of 64 entries, as the JAX package's `_jitted_render` lru_cache. Each
entry holds

  * a static buffer per fresh input, which a replay `copy_`s the caller's
    tensor into (nothing is copied when the caller passes the buffer);
    the entries whose inputs have the same shapes share these buffers
    (their replays are serialized), so the render graphs of one map at
    several image sizes hold one copy of the map;
  * the resident inputs, which the graph reads and writes where they lie
    (a trainer's map and Adam state: the donation of JAX's
    `donate_argnames`);
  * static outputs, made before the capture outside the graphs' memory
    pool, so that no other graph of the owner overwrites them;
  * the kernel launches the capture recorded and its replays.

The graphs of one owner share one memory pool (graph_pool_handle()): they
replay one after another on the owner's streams, and a replay on a stream
other than the last one's waits for the last replay first.

A capture first runs the function once on scratch copies of its inputs on
the capture stream (the cuBLAS and cuDNN handles, autograd's device
threads, the kernels' first-use build), so the warm-up changes no input,
then captures it with capture_error_mode="thread_local": other threads
(the tracker's ORB on its own stream, viewer clients) keep issuing CUDA
calls meanwhile. A capture that fails raises; nothing falls back to eager
dispatch. On tensors that are not on a CUDA device the cache calls the
function directly: the port's plain route, which the CPU tests run.
`tracing()` says whether the calling thread is inside a warm-up or a
capture, so a test can tell the calls a graph records from op-by-op ones.

What runs through a GraphCache: ops/render.py::render_jit (the serving
renders) and mapper/trainer.py::StepGraphs, which holds one map resident
and replays on it train_step, train_chunk, the B-view step, densify and
prune, the opacity reset, the two map transforms, and, on a card whose
process group is NCCL, the multi-process functions of parallel/sharding.py
with their collectives inside the graph (one capture per rank). A gloo
group cannot be captured: the graph route refuses it on a card
(sharding.graph_route) rather than dispatching op by op in its place.

Kernel wrappers count their launches (`wrapper.launches`) through
`count_launch`: a launch made while the current stream captures goes to
that capture's tally instead (it runs only when the graph replays), and
each replay adds the tally to the counts. So the counts are the launches
that ran, replays and warm-ups included.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable, Optional, Sequence

import torch

GRAPH_CACHE_SIZE = 64

# Raw stream handle -> {wrapper: launches} of the capture running on it.
_capturing: dict[int, dict] = {}
# Per thread: how deep it is inside GraphCache._capture (warm-up or
# capture).
_tracing = threading.local()


def tracing() -> bool:
    """Whether the calling thread is inside a GraphCache's warm-up or
    capture of a function (not a replay, not a direct call)."""
    return getattr(_tracing, "depth", 0) > 0


def _current_stream_handle(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def count_launch(wrapper, device: torch.device) -> None:
    """Count one launch of `wrapper`'s kernel on `device`: into the tally
    of the capture that the current stream is part of, if any, else into
    wrapper.launches."""
    if _capturing:
        tally = _capturing.get(_current_stream_handle(device))
        if tally is not None:
            tally[wrapper] = tally.get(wrapper, 0) + 1
            return
    wrapper.launches += 1


def add_launches(tally: dict, replays: int = 1) -> None:
    """Add a capture's tally, times `replays`, to its wrappers' counts."""
    for wrapper, n in tally.items():
        wrapper.launches += n * replays


def is_capturing(device: torch.device) -> bool:
    """Whether the current stream of `device` is being captured."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def spec(x: torch.Tensor) -> tuple:
    return (tuple(x.shape), x.dtype, x.device)


def numerics() -> tuple:
    """The global float32 math flags a captured graph freezes (the TF32
    switches of cuBLAS and cuDNN, the matmul precision): part of every key,
    so that a graph is captured anew under other flags, as JAX's jit cache
    keys on its default matmul precision."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


class Graphed:
    """One captured graph and its buffers."""

    def __init__(self, graph, fresh, outputs, launches):
        self.graph = graph
        self.fresh = fresh          # static input buffers
        self.outputs = outputs      # static outputs
        self.launches = launches    # {wrapper: launches} a replay makes
        self.replays = 0


class GraphCache:
    """Captured graphs of one owner, LRU-bounded (see the module
    docstring)."""

    def __init__(self):
        self._entries: "OrderedDict[Hashable, Graphed]" = OrderedDict()
        # (position, shape, dtype, device) -> a fresh input's buffer.
        self._inputs: dict[tuple, torch.Tensor] = {}
        self._lock = threading.RLock()
        self._pool = None
        self._streams: dict[int, torch.cuda.Stream] = {}
        self._done: Optional[torch.cuda.Event] = None
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        return list(self._entries)

    def clear(self) -> None:
        """Drop every graph (e.g. when the resident tensors are
        reallocated: a capacity growth)."""
        with self._lock:
            self._entries.clear()
            self._inputs.clear()

    def evict(self, pred: Callable) -> None:
        """Drop the graphs whose entry satisfies pred(entry), and the input
        buffers that no other graph uses."""
        with self._lock:
            for k in [k for k, e in self._entries.items() if pred(e)]:
                del self._entries[k]
            self._drop_unused_inputs()

    def input_buffer(self, position: int, shape: tuple, dtype,
                     device: torch.device) -> torch.Tensor:
        """The static buffer of fresh input `position` for tensors of this
        shape, dtype and device (made empty when there is none yet): a
        caller that fills it and passes it as that input saves the
        replay's copy."""
        with self._lock:
            key = (position, tuple(shape), dtype, device)
            buf = self._inputs.get(key)
            if buf is None:
                buf = self._inputs[key] = torch.empty(shape, dtype=dtype,
                                                      device=device)
            return buf

    def _drop_unused_inputs(self) -> None:
        used = {id(b) for e in self._entries.values()
                for b in getattr(e, "fresh", ())}
        self._inputs = {k: b for k, b in self._inputs.items()
                        if id(b) in used}

    @staticmethod
    def key_of(key: Hashable, fresh: Sequence, resident: Sequence = ()
               ) -> tuple:
        """The entry key of a call: the caller's key, the device, the
        float32 math flags (numerics), the fresh inputs' shapes and dtypes,
        and the resident inputs' shapes, dtypes and addresses."""
        return (key, (*fresh, *resident)[0].device, numerics(),
                tuple(spec(x) for x in fresh),
                tuple(spec(x) + (x.data_ptr(),) for x in resident))

    def entry(self, full_key: tuple, make: Callable):
        """The entry of `full_key`, made by make() when there is none; the
        least recently used entries beyond GRAPH_CACHE_SIZE are dropped."""
        with self._lock:
            entry = self._entries.get(full_key)
            if entry is None:
                entry = self._entries[full_key] = make()
                if len(self._entries) > GRAPH_CACHE_SIZE:
                    while len(self._entries) > GRAPH_CACHE_SIZE:
                        self._entries.popitem(last=False)
                    self._drop_unused_inputs()
            else:
                self._entries.move_to_end(full_key)
            return entry

    def run(self, key: Hashable, fn: Callable, fresh: Sequence, resident:
            Sequence = (), clone: bool = False, replays: int = 1) -> tuple:
        """fn(*fresh, *resident) -> a tuple of tensors, replayed `replays`
        times from the graph of `key` (captured at the first call with this
        key and these inputs' shapes). `fresh` tensors are copied into the
        graph's buffers once; `resident` tensors are read and written where
        they lie. Returns the static outputs (overwritten by the next
        replay of the same graph), or clones of them when `clone` (for
        callers on other threads)."""
        tensors = (*fresh, *resident)
        dev = tensors[0].device
        if dev.type != "cuda":
            out = ()
            for _ in range(replays):
                out = tuple(fn(*tensors))
            return out
        with self._lock, torch.cuda.device(dev):
            entry = self.entry(self.key_of(key, fresh, resident),
                               lambda: self._capture(fn, fresh, resident,
                                                     dev))
            stream = torch.cuda.current_stream(dev)
            if self._done is not None:
                stream.wait_event(self._done)
            for buf, x in zip(entry.fresh, fresh):
                if x is not buf:
                    buf.copy_(x)
            for _ in range(replays):
                entry.graph.replay()
            entry.replays += replays
            self.replays += replays
            add_launches(entry.launches, replays)
            out = tuple(o.clone() for o in entry.outputs) if clone \
                else entry.outputs
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(stream)
            return out

    def _capture(self, fn, fresh, resident, dev) -> Graphed:
        stream = self._streams.get(dev.index)
        if stream is None:
            stream = self._streams.setdefault(dev.index,
                                              torch.cuda.Stream(dev))
        stream.wait_stream(torch.cuda.current_stream(dev))
        _tracing.depth = getattr(_tracing, "depth", 0) + 1
        try:
            return self._warm_and_capture(fn, fresh, resident, dev, stream)
        finally:
            _tracing.depth -= 1

    def _warm_and_capture(self, fn, fresh, resident, dev, stream
                          ) -> Graphed:
        with torch.cuda.stream(stream):
            # The warm-up on scratch copies: nothing the caller holds
            # changes.
            scratch = [x.clone() for x in (*fresh, *resident)]
            warm = tuple(fn(*scratch))
            outputs = tuple(torch.empty_like(o) for o in warm)
            static = []
            for i, x in enumerate(fresh):
                buf = self._inputs.get((i, *spec(x)))
                if buf is None:
                    buf = self._inputs[(i, *spec(x))] = x.clone()
                static.append(buf)
            del scratch, warm
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        tally: dict = {}
        handle = stream.cuda_stream
        _capturing[handle] = tally
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = tuple(fn(*static, *resident))
                if len(out) != len(outputs):
                    raise RuntimeError("graph capture: the function "
                                       "returned another number of "
                                       "outputs than in its warm-up")
                for buf, o in zip(outputs, out):
                    buf.copy_(o)
                del out
        finally:
            del _capturing[handle]
        self.captures += 1
        torch.cuda.current_stream(dev).wait_stream(stream)
        return Graphed(graph, tuple(static), outputs, tally)
