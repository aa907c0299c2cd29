"""Executables: the port's counterpart of `jax.jit`, for the engines and the
trainer, and their caches.

The JAX engines and the JAX train step keep one compiled program per
shape signature and dispatch it asynchronously, so the host pays one
dispatch per batch. The port's counterpart is a CUDA graph: a function run once on static input
buffers while the stream is captured, then replayed by one host call
whatever the number of kernels inside. An `Executable` holds one such
program:

- on CUDA, a `torch.cuda.CUDAGraph`, its static inputs (device buffers the
  host copies each call's values into), its static outputs (read back or
  cloned before the next replay) and the flash-attention launches the
  capture recorded on its stream (`ops/flash_attention.take_captured`,
  the backward's B2 and B3 included, which autograd's device thread
  records), which every replay adds to the launch counts;
- on the CPU, the eager function: the same cache, LRU and counts, so the
  CPU tests hold them to the JAX engine's.

A capture first runs the function once on a side stream, eagerly, so the
first-use work a capture may not do (the kernels' build and load, cuBLAS
handles and workspaces, the allocator's growth) is done; then captures it
on that stream with `capture_error_mode="thread_local"`, so another
thread's CUDA calls do not break it, and one capture runs at a time in the
process. A capture that fails raises: there is no eager fallback on CUDA.

The kernels take their TMA descriptors as launch parameters encoded from
the tensors' addresses, so a graph replays on the addresses of its
capture: the static buffers are what make a replay right. The graphs of
one owner (an engine, an optimizer's steps) share one memory pool; the
owner serialises their replays with one lock held from the copy in to
the enqueued copy out, so
one graph's intermediates never overwrite another's outputs before they
are read. Static inputs live outside the pool.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch

from symbiont_tpu_torch.obs.xprof import dispatch_ledger, executable_cost, tensor_bytes
from symbiont_tpu_torch.ops import flash_attention as fa

# one capture at a time in the process (torch's own rule for its capture
# stream), and one side stream for every warm-up and capture: a stream that
# runs a GEMM holds a cuBLAS workspace of its own until the process ends.
# The graphs a thread captures there share that thread's workspace for the
# side stream, and so does its next warm-up, which runs eagerly: a warm-up
# must not run on the card while a graph replays, or both write the one
# workspace. `_side_lock` orders them: a warm-up holds it from its enqueue
# to its end on the card, and every replay holds it while it enqueues, so
# a replay enqueued after a warm-up runs after it (the warm-up waited on
# the caller's stream before it began).
_capture_lock = threading.Lock()
_side_lock = threading.Lock()
_capture_stream: Optional[torch.cuda.Stream] = None


def _side_stream() -> "torch.cuda.Stream":
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    return _capture_stream


class GraphPool:
    """One memory pool for an owner's graphs. torch names a pool by the id
    of the graphs captured into it and retires the id once the last of
    them is gone, so a capture passes on a live graph's `pool()` (and
    holds that graph until its own capture has begun), and a capture with
    none alive starts a new pool."""

    def __init__(self):
        self._live: "weakref.WeakSet[Executable]" = weakref.WeakSet()
        self._ids: set = set()  # every pool id its captures have used

    def anchor(self) -> Optional["Executable"]:
        """A live executable of the pool, or None."""
        return next((exe for exe in list(self._live) if exe.graph is not None), None)

    def add(self, exe: "Executable") -> None:
        self._live.add(exe)
        self._ids.add(tuple(exe.graph.pool()))

    def nbytes(self) -> int:
        """Device bytes allocated in this owner's pool segments: its live
        graphs' outputs and what they hold (the device-memory ledger's
        claim; the allocator's host metadata, no device sync)."""
        ids = set(self._ids)
        if not ids:
            return 0
        return sum(seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", (0, 0))) in ids)


def _pool_bytes(pool_id) -> int:
    """Device bytes the allocator holds in the segments of one graph pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool_id))


def graph_pool_bytes(device=None) -> int:
    """Device bytes the allocator holds in CUDA-graph pools (segments whose
    pool id is not the default one's), every owner's graphs together."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)
               and (device is None or seg["device"] == torch.device(device).index))


class Executable:
    """One program of fixed input shapes. `fn(*inputs)` returns a tensor or
    a tuple of tensors; `__call__(*inputs)` returns the same, computed by a
    replay on CUDA (fresh tensors, safe to keep across later replays) and
    by `fn` itself on the CPU. `inputs` may live on the CPU or the device:
    on CUDA they are copied into the static buffers.

    `on_first(seconds)` is called once, by the first call, with its wall:
    on CUDA the warm-up, the capture and the first replay, on the CPU the
    call itself (the JAX engine's first-call compile seconds). Two threads
    that make the first call together capture once; the other waits.

    `generators`: CUDA generators `fn` draws from, registered with the
    graph so a replay draws what the eager call would (the graph reads the
    generator's seed and offset when it replays and advances the offset).
    `carry`: tensors `fn` writes in place (a decode's logits, positions and
    done flags), held here because the graph is bound to their storage;
    the warm-up run's writes to them are undone before the capture. (A
    decode's cache is written too, at slots the real run writes again
    before it reads them.) `warm`: what the warm-up runs instead of `fn`,
    the same kernels at less cost (one decode step of a chunk's), and
    `warm_scale` how many warm-ups the function's work is.

    `cost` and `memory`: the analysis taken once, as JAX's
    `compile_analysis_for` at its compile seam. The cost
    (`obs/xprof.executable_cost`) counts the warm-up's ops on the card, the
    first call's on the CPU. The memory, on the card only: `temp_bytes`
    the graph pool's growth over the capture, `argument_bytes` and
    `output_bytes` the static inputs' and outputs' bytes. With a
    `signature`, the first call notes the capture and both analyses in the
    dispatch ledger (`note_compile`) before `on_first` runs."""

    def __init__(self, fn: Callable, device, pool: Optional[GraphPool] = None,
                 generators: Sequence[torch.Generator] = (), carry=None,
                 on_first: Optional[Callable[[float], None]] = None,
                 warm: Optional[Callable] = None, warm_scale: int = 1,
                 signature: Optional[str] = None):
        self.fn = fn
        self.warm = warm or fn
        self.warm_scale = warm_scale if warm is not None else 1
        self.signature = signature
        self.cost: Optional[dict] = None
        self.memory: Optional[dict] = None
        self.device = torch.device(device)
        self.pool = pool
        self.generators = tuple(generators)
        self.carry = carry
        self.on_first = on_first
        self._first_lock = threading.Lock()
        self._first_done = False
        self.graph = None
        self.static_in: tuple = ()
        self.static_out = None
        self.counts = (0, 0, 0)  # B1, B2, B3 recorded per replay
        self.capture_s = 0.0     # warm-up + capture, host wall
        # capture_s by part: lock_wait, warm (the eager run), end
        # (capture_end, the graph's instantiation) and record (the rest)
        self.capture_parts: dict = {}
        self.replays = 0

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def capture(self, inputs) -> None:
        """Static inputs filled with `inputs`, a warm-up run on the side
        stream, then the capture on it. Generators and the carry come back
        to the state they had before the warm-up. No replay."""
        t0 = time.perf_counter()
        self.static_in = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device)
                               for x in inputs)
        for s, x in zip(self.static_in, inputs):
            s.copy_(x, non_blocking=True)
        states = [g.get_state() for g in self.generators]
        saved = [t.clone() for t in self.carry or ()]
        parts = {}
        with _capture_lock:
            parts["lock_wait"] = time.perf_counter() - t0
            side = _side_stream()
            with _side_lock:
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    _, self.cost = executable_cost(self.warm, *self.static_in,
                                                   scale=self.warm_scale)
                    for t, was in zip(self.carry or (), saved):
                        t.copy_(was)
                side.synchronize()
            parts["warm"] = time.perf_counter() - t0 - parts["lock_wait"]
            for g, st in zip(self.generators, states):
                g.set_state(st)
            fa.take_captured(side)  # nothing of an earlier capture is pending
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            anchor = None if self.pool is None else self.pool.anchor()
            pool0 = _pool_bytes(anchor.graph.pool()) if anchor is not None else 0
            with torch.cuda.stream(side):
                graph.capture_begin(pool=None if anchor is None else anchor.graph.pool(),
                                    capture_error_mode="thread_local")
                del anchor
                try:
                    out = self.fn(*self.static_in)
                except BaseException:
                    fa.take_captured(side)
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already; its cause is raised
                    raise
                t_end = time.perf_counter()
                graph.capture_end()
            parts["end"] = time.perf_counter() - t_end
            self.counts = fa.take_captured(side)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph, self.static_out = graph, out
            if self.pool is not None:
                self.pool.add(self)
            self.memory = {"temp_bytes": max(0, _pool_bytes(graph.pool()) - pool0),
                           "argument_bytes": tensor_bytes(self.static_in),
                           "output_bytes": tensor_bytes(out)}
        self.capture_s = time.perf_counter() - t0
        parts["record"] = self.capture_s - sum(parts.values())
        self.capture_parts = parts

    def replay(self, inputs) -> None:
        """Copy `inputs` into the static buffers and replay the captured
        graph. The caller holds the owner's replay lock and reads
        `static_out` (or enqueues its copy out) before it lets go."""
        for s, x in zip(self.static_in, inputs):
            s.copy_(x, non_blocking=True)
        with _side_lock:
            self.graph.replay()
        self.replays += 1
        fa.note_replay(self.counts)

    def _run(self, inputs, lock):
        if not self.cuda:
            if self.cost is None:  # the first call: eager, counted
                out, self.cost = executable_cost(self.fn, *inputs)
                return out
            return self.fn(*inputs)
        if self.graph is None:  # the first call, under _first_lock
            self.capture(inputs)
        with lock if lock is not None else contextlib.nullcontext():
            self.replay(inputs)
            out = self.static_out
            return (out.clone() if isinstance(out, torch.Tensor)
                    else tuple(o.clone() for o in out))

    def __call__(self, *inputs, lock: Optional[threading.Lock] = None):
        if not self._first_done:
            with self._first_lock:
                if not self._first_done:
                    t0 = time.perf_counter()
                    out = self._run(inputs, lock)
                    self._first_done = True
                    if self.signature is not None:
                        dispatch_ledger.note_compile(self.signature, self.cost, self.memory)
                    if self.on_first is not None:
                        self.on_first(time.perf_counter() - t0)
                    return out
        return self._run(inputs, lock)


class ExecCache:
    """The engines' executable cache: one `Executable` per key, least
    recently used first out past `size` (None: no count bound, the owner
    bounds the cache by what it holds, with `drop`), as
    `TpuEngine._exec_cache`. Two threads that miss one cold key both
    build; the loser drops its executable and takes the winner's, so one
    key never counts twice."""

    def __init__(self, size: Optional[int]):
        self.size = None if size is None else max(1, int(size))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[object, Executable]" = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key) -> Optional[Executable]:
        with self._lock:
            exe = self._entries.get(key)
            if exe is not None:
                self._entries.move_to_end(key)
            return exe

    def put(self, key, exe: Executable) -> tuple:
        """(the cached executable, whether `exe` won the key)."""
        with self._lock:
            have = self._entries.get(key)
            if have is not None:
                self._entries.move_to_end(key)
                return have, False
            self._entries[key] = exe
            while self.size is not None and len(self._entries) > self.size:
                self._entries.popitem(last=False)
            return exe, True

    def drop(self, key) -> None:
        """Forget `key`'s executable (one bound to replaced state)."""
        with self._lock:
            self._entries.pop(key, None)

    def items(self) -> list:
        with self._lock:
            return list(self._entries.items())
