"""Build and load the CUDA kernels: ``nvcc`` into one shared library with
a plain C interface, loaded with ``ctypes``.

At first use, every ``csrc/*.cu`` is compiled (one ``nvcc`` each, in
parallel) and linked for ``sm_90a`` into
``build/repro_torch/<hash>/libreprotorch_kernels.so`` at the root of the
checkout, keyed by a hash of the sources and flags, so an unchanged tree
reuses its library.  A failed build or load raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libreprotorch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# -Xptxas -v only reports registers, shared memory and spills per kernel
COMPILE_FLAGS = ARCH_FLAGS + ("-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_F = ctypes.c_float
_C = ctypes.c_int
# C entry point -> argument types; every one returns cudaError_t as int
SIGNATURES = {
    # the grouped entries take ops, a host array of card pointers piece by
    # piece, and n, the number of pieces; then w; W, N; stream
    "fedavg_agg_launch": (_P, _C, _P, _I64, _I64, _P),
    "fedavg_mix_launch": (_P, _C, _P, _I64, _I64, _P),
    # ops (q, base, server, out a piece), n; scale; w; N; stream
    "fedavg_dequant_mix_launch": (_P, _C, _P, _P, _I64, _P),
    # ops, n; w; adam; 4 scalars; W, N; stream
    "fedavg_merge_opt_launch": (_P, _C, _P, _C) + (_F,) * 4
    + (_I64, _I64, _P),
    "topk_quant_encode_launch": (_P, _P, _P, _P, _P, _I64, _P),
    # ops (q, base, out a piece), n; scale; N; stream
    "dequant_add_launch": (_P, _C, _P, _I64, _P),
    # ctas, dynamic shared memory, int* clusters
    "ef_cluster_max_active": (_C, _I64, _P),
    # a, b, c; N, stride, m, k; sweep, quantize; part, n_part; q, recon,
    # r, dec, thresh, scale, kept; ctas; stream
    "ef_encode_cluster_launch": (_P,) * 3 + (_I64,) * 4 + (_C, _C)
    + (_P, _I64) + (_P,) * 7 + (_C, _P),
    # the grid and sharded forms' passes: a, b, c; N, off, stride, m;
    # sample, x, part_max, part_kept, zero; blocks; stream
    "ef_encode_pass1_launch": (_P,) * 3 + (_I64,) * 4 + (_P,) * 5
    + (_C, _P),
    # x; N; ts; quantize; q, recon, r, base, dec, part_kept, kept; blocks;
    # stream
    "ef_encode_pass2_launch": (_P, _I64, _P, _C) + (_P,) * 7 + (_C, _P),
    # part_max, n_max, part_kept, n_kept; thresh, scale, kept; stream
    "ef_encode_reduce_launch": (_P, _I64, _P, _I64) + (_P,) * 3 + (_P,),
    # host arrays of q, scale and base pointers (q and base a decode's
    # pieces); n_dec, n_zero; host array of the pieces' rows, n_pieces; N;
    # stream
    "dequant_add_rows_launch": (_P, _P, _P, _C, _C, _P, _C, _I64, _P),
    # ops, n; 4 scalars; N; stream
    "server_opt_mom_launch": (_P, _C) + (_F,) * 4 + (_I64, _P),
    "server_opt_adam_launch": (_P, _C) + (_F,) * 4 + (_I64, _P),
    # q, k, v, o; B, S, T, H, Kv, D; 12 strides; causal, window; scale,
    # softcap; dtype; stream
    "flash_attention_launch": (_P,) * 4 + (_I64,) * 6 + (_I64,) * 12
    + (_I64, _I64, _F, _F, _I64, _P),
    # dtype, D -> 1 when the launch runs the tensor-core body
    "flash_attention_wgmma_body": (_I64, _I64),
    # r, k, v, w, u, s0, y, state, ds, ea; B, S, H, K, chunk; 15 strides;
    # dtype; stream
    "wkv_launch": (_P,) * 10 + (_I64,) * 5 + (_I64,) * 15 + (_I64, _P),
}

_lock = threading.Lock()
_lib = None
build_log = ""           # nvcc's per-kernel resource report of the library
LOG_NAME = "ptxas.log"   # that report, kept beside the library


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources unless the library for this hash exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    global build_log
    out = library_path()
    log = out.with_name(LOG_NAME)
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in _sources():
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    logs = []
    for cmd, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{logs[-1]}")
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    build_log = "".join(logs)
    # the report goes beside the library, first: a later load reads it back
    log_tmp = log.with_name(f"{LOG_NAME}.{tag}")
    log_tmp.write_text(build_log)
    os.replace(log_tmp, log)
    os.replace(tmp, out)          # atomic: concurrent builds agree
    for obj in objs:
        obj.unlink()
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib
