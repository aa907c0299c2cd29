"""The compute plane's dispatch ledger, the executables' cost and memory
analysis, and the on-demand device trace.

The port's copy of `symbiont_tpu/obs/xprof.py`:

- `DispatchLedger`: one row per call signature (`embed[L=..,B=..]`,
  `qsearch[...]`, `lm.verify_chunk[...]`, ...) with its dispatch count,
  the host wall spent enqueuing it, its captures and, from each capture,
  the executable's cost (`flops`, `bytes_accessed`) and memory
  (`temp_bytes`, `argument_bytes`, `output_bytes`), plus
  `engine.host_syncs_total{site}`, the device → host fetches per call
  site. The counter families keep the JAX package's names
  (`xla.dispatches_total{executable}`), so one dashboard reads both.
- `executable_cost`: the counterpart of XLA's cost model for a CUDA graph
  (`graphs.Executable` runs it at its capture's warm-up, or at its first
  call on the CPU): every aten op of the run counted under a dispatch
  mode, operations as `torch.utils.flop_counter` counts them and bytes as
  the operand and result bytes of each op that is not a view, plus the
  flash-attention kernels' operations and bytes by the formulas of their
  bounds (`ops/flash_attention.kernel_work`), which no torch mode sees.
  `generated_code_bytes` is never set: unknown is not zero.
- `grade_executable`: a copy of `symbiont_tpu/bench/roofline.py`'s, the
  roofline grade of one ledger row.
- `DeviceTraceCapture`: a bounded `torch.profiler` window (CPU and CUDA
  activities) written as a Chrome trace into its artifact directory,
  under telemetry's `_profile_lock`, with JAX's `busy`/`error`/`captured`
  statuses and `profile.device_*` counters. Served at
  `POST /api/profile/device`.
- `known_sync_sites`: as in JAX, the host-sync sites read from the lint
  allowlist (`lint/allowlist.py` `TORCH_HOST_SYNC_ALLOWED`), so the
  runtime counters and the static inventory are one list.
"""

from __future__ import annotations

import importlib
import os
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from symbiont_tpu_torch.utils.telemetry import metrics


def known_sync_sites() -> tuple:
    """The static host-sync inventory, as runtime counter site names.

    Single source of truth is the lint allowlist — the runtime audit can
    never drift from the static one because it IS the static one.
    """
    from symbiont_tpu_torch.lint.allowlist import TORCH_HOST_SYNC_ALLOWED

    return tuple(sorted(scope for (_file, scope) in TORCH_HOST_SYNC_ALLOWED))


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd

# the products `torch.utils.flop_counter` leaves out: a matrix-vector
# product (a store's search scores one query) and a dot product
_VECTOR_FLOPS = {
    torch.ops.aten.mv: lambda mat, vec, out_val=None: 2 * mat.shape[0] * mat.shape[1],
    torch.ops.aten.dot: lambda a, b, out_val=None: 2 * a.shape[0],
}


class CostMode(TorchDispatchMode):
    """Counts the aten ops run inside it: `flops` as
    `torch.utils.flop_counter` counts the ops it knows (matmuls,
    convolutions, attention) and `_VECTOR_FLOPS` the vector products,
    `bytes_accessed` as the bytes of each op's
    tensor operands and results, views left out (they move nothing) and
    composite ops counted by their parts."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing under this mode is compiled: wrapped in dynamo's disable,
        # its first dispatch would import torch._dynamo, seconds on the
        # first request a role serves
        return False

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (matmul, einsum under inference mode) runs as its
        # decomposition, as it would without the mode, so its parts count:
        # torch's own C++ one where there is one, as a plain call runs it
        # (the Python one of `torch._decomp` imports sympy, seconds on the
        # first request a role serves)
        count = (self._flop_registry.get(func._overloadpacket)
                 or _VECTOR_FLOPS.get(func._overloadpacket))
        if count is None:
            with self:  # the parts come back through this mode
                if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _COMPOSITE):
                    return func._op_dk(_COMPOSITE, *args, **kwargs)
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not func.is_view:
            if count is not None:
                try:
                    self.flops += float(count(*args, **kwargs, out_val=out))
                except Exception:  # a formula that cannot read these arguments
                    pass  # its flops are left out; the capture must not fail for a count
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in tree_leaves((args, kwargs, out))
                                       if isinstance(t, torch.Tensor))
        return out


def _import_dynamo() -> None:
    """Import `torch._dynamo`, where this torch wraps `CostMode`'s dispatch
    in dynamo's disable all the same, on a thread of its own the first
    time: the import machinery's frames form cycles that keep the
    importing stack alive until a cyclic collection, and that stack would
    otherwise be an engine's."""
    wrapped = hasattr(CostMode.__dict__["__torch_dispatch__"], "__wrapped__")
    if wrapped and "torch._dynamo" not in sys.modules:
        t = threading.Thread(target=importlib.import_module, args=("torch._dynamo",))
        t.start()
        t.join()


def executable_cost(fn, *inputs, scale: int = 1):
    """(fn's result, its cost `{"flops", "bytes_accessed"}`) from one run
    under `CostMode` with the flash-attention launches on the current
    stream counted; `scale`: how many such runs the executable's work is
    (a decode chunk's warm-up is one step of its chunk)."""
    from symbiont_tpu_torch.ops import flash_attention as fa

    _import_dynamo()
    with fa.count_work() as kernels, CostMode() as mode:
        out = fn(*inputs)
    return out, {"flops": (mode.flops + kernels[0]) * scale,
                 "bytes_accessed": float((mode.bytes_accessed + kernels[1]) * scale)}


def tensor_bytes(tensors) -> int:
    """Bytes of the tensors among `tensors` (a tensor, a tuple, nested)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tensors)
               if isinstance(t, torch.Tensor))


def grade_executable(flops: Optional[float], bytes_accessed: Optional[float],
                     wall_s: float, dispatches: int,
                     ref_gbps: Optional[float] = None) -> dict:
    """Copy of `symbiont_tpu/bench/roofline.py`'s `grade_executable`: one
    executable placed on the roofline from its cost and its measured host
    wall. Achieved rates divide the work of a dispatch by the mean host
    wall per dispatch, an underestimate of the device's rates wherever the
    wall holds host overhead; `hbm_util_vs_ref_pct` grades the bytes rate
    against a reference rate when the caller has one. All None without a
    cost: unknown is not zero."""
    if (flops is None and bytes_accessed is None) or dispatches <= 0 or wall_s <= 0:
        return {"achieved_gflops_per_s": None, "achieved_gbps": None,
                "arithmetic_intensity": None, "hbm_util_vs_ref_pct": None}
    per_dispatch_s = wall_s / dispatches
    gflops = None if not flops else round(flops / per_dispatch_s / 1e9, 2)
    gbps = None if not bytes_accessed else round(bytes_accessed / per_dispatch_s / 1e9, 2)
    intensity = round(flops / bytes_accessed, 2) if flops and bytes_accessed else None
    util = (round(100.0 * (bytes_accessed / per_dispatch_s / 1e9) / ref_gbps, 1)
            if bytes_accessed and ref_gbps else None)
    return {"achieved_gflops_per_s": gflops, "achieved_gbps": gbps,
            "arithmetic_intensity": intensity, "hbm_util_vs_ref_pct": util}


_MEMORY_FIELDS = ("temp_bytes", "argument_bytes", "output_bytes", "generated_code_bytes")


class _SigStats:
    __slots__ = ("dispatches", "wall_s", "compiles", "flops", "bytes_accessed",
                 *_MEMORY_FIELDS)

    def __init__(self) -> None:
        self.dispatches = 0
        self.wall_s = 0.0
        self.compiles = 0
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        for name in _MEMORY_FIELDS:
            setattr(self, name, None)


class DispatchLedger:
    """Bounded per-signature dispatch table (least recently used rows go
    past `max_executables`)."""

    def __init__(self, max_executables: int = 256, registry=None) -> None:
        self.registry = registry if registry is not None else metrics
        self._lock = threading.Lock()
        self._rows: "OrderedDict[str, _SigStats]" = OrderedDict()
        self._max = max(1, int(max_executables))
        self._enabled = True

    def configure(self, enabled: bool = True,
                  max_executables: Optional[int] = None) -> None:
        with self._lock:
            self._enabled = bool(enabled)
            if max_executables is not None:
                self._max = max(1, int(max_executables))
                while len(self._rows) > self._max:
                    self._rows.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()

    def _entry(self, signature: str) -> _SigStats:
        # caller holds self._lock
        st = self._rows.get(signature)
        if st is None:
            st = self._rows[signature] = _SigStats()
            while len(self._rows) > self._max:
                self._rows.popitem(last=False)
        else:
            self._rows.move_to_end(signature)
        return st

    def note_dispatch(self, signature: str, wall_s: float) -> None:
        """One call of `signature` and the host wall around its enqueue."""
        if not self._enabled:
            return
        with self._lock:
            st = self._entry(signature)
            st.dispatches += 1
            st.wall_s += wall_s
        self.registry.inc("xla.dispatches_total", labels={"executable": signature})

    def note_compile(self, signature: str, cost: Optional[dict],
                     memory: Optional[dict] = None) -> None:
        """First call of an executable (its capture on the card), with its
        cost and, where it was measured, its memory (`executable_cost`,
        `graphs.Executable`)."""
        if not self._enabled:
            return
        with self._lock:
            st = self._entry(signature)
            st.compiles += 1
            if cost is not None:
                st.flops = cost.get("flops")
                st.bytes_accessed = cost.get("bytes_accessed")
            if memory is not None:
                for name in _MEMORY_FIELDS:
                    if name in memory:
                        setattr(st, name, int(memory[name]))

    def note_host_sync(self, site: str, n: int = 1) -> None:
        """`n` device → host fetches at `site`."""
        if not self._enabled:
            return
        self.registry.inc("engine.host_syncs_total", n, labels={"site": site})

    def register_zero(self) -> None:
        """The ledger's counter families at zero, one host-sync series per
        known site, so `/metrics` shows them before any traffic."""
        self.registry.inc("xla.dispatches_total", 0, labels={"executable": "all"})
        for site in known_sync_sites():
            self.registry.inc("engine.host_syncs_total", 0, labels={"site": site})

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def snapshot(self) -> list:
        """Per-signature rows, most dispatches first; cost and memory
        fields None where unknown."""
        with self._lock:
            rows = [(sig, st.dispatches, st.wall_s, st.compiles, st.flops, st.bytes_accessed,
                     *(getattr(st, name) for name in _MEMORY_FIELDS))
                    for sig, st in self._rows.items()]
        out = []
        for sig, n, wall, compiles, flops, nbytes, *mem in rows:
            out.append({"executable": sig, "dispatches": n, "compiles": compiles,
                        "host_wall_ms": round(wall * 1000.0, 3),
                        "mean_dispatch_us": round(wall / n * 1e6, 1) if n else 0.0,
                        "flops": flops, "bytes_accessed": nbytes,
                        **dict(zip(_MEMORY_FIELDS, mem))})
        out.sort(key=lambda r: -r["dispatches"])
        return out


class DeviceTraceCapture:
    """An on-demand bounded `torch.profiler` window over the CPU and the
    card. The profiler is process-wide and not reentrant, so captures
    share telemetry's `_profile_lock` with `maybe_profile`: a held lock
    answers "busy"; a profiler that cannot start answers "error"."""

    def __init__(self) -> None:
        self._trace_dir = os.path.join(tempfile.gettempdir(), "symbiont_xprof")
        self._max_s = 30.0
        self._last_artifact: Optional[str] = None
        self._seq = 0

    def configure(self, trace_dir: Optional[str] = None,
                  max_s: Optional[float] = None) -> None:
        if trace_dir:
            self._trace_dir = str(trace_dir)
        if max_s is not None:
            self._max_s = float(max_s)

    @property
    def last_artifact(self) -> Optional[str]:
        return self._last_artifact

    def capture(self, duration_s: float = 1.0) -> dict:
        """Trace the host and the card for `duration_s` (clamped to the
        configured `max_s`) → the artifact directory, holding
        `trace.json` (Chrome trace format), or a busy/error status."""
        from symbiont_tpu_torch.utils import telemetry

        try:
            dur = float(duration_s)
        except (TypeError, ValueError):
            raise ValueError("duration_s must be a number")
        if dur <= 0:
            raise ValueError("duration_s must be positive")
        dur = min(dur, self._max_s)
        if not telemetry._profile_lock.acquire(blocking=False):
            metrics.inc("profile.device_busy")
            return {"status": "busy", "detail": "a profiler capture is already in flight"}
        try:
            self._seq += 1
            artifact = os.path.join(self._trace_dir, f"device_trace_{self._seq:04d}")
            os.makedirs(artifact, exist_ok=True)
            from torch.profiler import ProfilerActivity, profile

            from symbiont_tpu_torch.graphs import _side_lock

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            t0 = time.perf_counter()
            # the profiler starts and stops while no CUDA graph launches:
            # its stop and another thread's graph launch can deadlock on the
            # card, and every replay launches under `_side_lock`
            with _side_lock:
                prof.start()
            try:
                time.sleep(dur)
            finally:
                with _side_lock:
                    prof.stop()
            wall = time.perf_counter() - t0
            prof.export_chrome_trace(os.path.join(artifact, "trace.json"))
        except Exception as e:  # a profiler that cannot start or export
            metrics.inc("profile.device_errors")
            return {"status": "error", "detail": str(e)}
        finally:
            telemetry._profile_lock.release()
        self._last_artifact = artifact
        metrics.inc("profile.device_captures")
        return {"status": "captured", "artifact": artifact, "window_s": round(wall, 3),
                "hint": "load trace.json in ui.perfetto.dev or chrome://tracing"}


# process-global instances, configured by the runner at boot
dispatch_ledger = DispatchLedger()
device_trace = DeviceTraceCapture()
