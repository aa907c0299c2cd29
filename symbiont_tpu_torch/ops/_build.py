"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded with `ctypes`. The library lands in
`build/torch_kernels/<hash of the sources and flags>/` at the repo root
(listed in .gitignore), so an edited source builds anew and an unchanged
one is reused. Nothing here runs at import: the first `load()` builds.

A missing `nvcc` or a failed build raises with the compiler's output; there
is no fallback. `nvcc` is looked up on PATH, then in `$CUDA_HOME/bin` and
`/usr/local/cuda/bin`.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libsymbiont_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of symbiont_tpu_torch are built from source at first "
        "use and need the CUDA toolkit")


def cuobjdump() -> str:
    """`cuobjdump` beside `nvcc`, else the copy Triton's package carries
    (`triton/backends/nvidia/bin/`); raises if neither is there."""
    try:
        beside = Path(_nvcc()).parent / "cuobjdump"
        if beside.is_file():
            return str(beside)
    except RuntimeError:
        pass
    spec = importlib.util.find_spec("triton")
    for root in (spec.submodule_search_locations or []) if spec else []:
        found = Path(root) / "backends" / "nvidia" / "bin" / "cuobjdump"
        if found.is_file():
            return str(found)
    raise RuntimeError("cuobjdump not found (beside nvcc, or under Triton's "
                       "triton/backends/nvidia/bin/): it reads the built kernels' SASS")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with the output of any failure.
    Returns each command's combined output (ptxas -v register reports)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build failed ({' '.join(cmd)}):\n{out}")
    return outs


def build() -> Path:
    """Compile the sources (if this hash has no library yet) → library path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    objs, cmds = [], []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"  # one name per process: builds may run at once
        objs.append(str(obj))
        cmds.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
    logs = _run_all(cmds)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    logs += _run_all([[nvcc, "-shared", "-o", str(tmp), *objs]])
    (out_dir / "build.log").write_text("\n".join(logs))
    tmp.replace(lib_path)  # atomic: a concurrent loader sees all or nothing
    for obj in objs:
        os.unlink(obj)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry's C
    signature declared (pointers and the stream as c_void_p)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            fn = lib.symbiont_flash_attn_fwd
            fn.argtypes = [vp, vp, vp, vp, vp, vp,  # q k v bias o lse
                           ci, ci, ci, ci, ci, ci,  # B NH NKV Sq Sk D
                           ci, ci, ctypes.c_float,  # is_bf16 causal scale
                           vp]                      # stream
            fn.restype = ci
            fn = lib.symbiont_flash_attn_bwd_kv
            fn.argtypes = [vp, vp, vp, vp, vp, vp, vp,  # q k v bias g lse delta
                           vp, vp, vp,              # dk dv dbias
                           ci, ci, ci, ci, ci,      # B NH Sq Sk D
                           ci, ci, ctypes.c_float,  # is_bf16 causal scale
                           vp]                      # stream
            fn.restype = ci
            fn = lib.symbiont_flash_attn_bwd_q
            fn.argtypes = [vp, vp, vp, vp, vp, vp, vp,  # q k v bias g lse delta
                           vp,                      # dq
                           ci, ci, ci, ci, ci,      # B NH Sq Sk D
                           ci, ci, ctypes.c_float,  # is_bf16 causal scale
                           vp]                      # stream
            fn.restype = ci
            _lib = lib
        return _lib
