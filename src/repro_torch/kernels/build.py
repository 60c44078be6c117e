"""Build, load and launch the port's CUDA kernels.

Route (b) of a hand-written kernel: every ``csrc/*.cu`` is compiled by its
own ``nvcc`` process (all started together) for ``sm_90a``, the objects are
linked into one shared library with a plain C interface, and the library is
loaded with ``ctypes``.  No PyTorch header is compiled, so a build takes
seconds.  The library lands in ``build/repro_torch_kernels/`` at the root of
the checkout, named by a digest of the sources and flags, so a changed
source is never served by a stale build.  Nothing here runs at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and counts
the launch in :data:`LAUNCHES` (under a lock: every thread's launches) and
in the calling thread's ``counting.scoped`` blocks.  :data:`LIBRARY_EVENTS`
counts the builds and loads of the library, so a warmed server can show it
loaded nothing more.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch import counting

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel name -> launches made by its wrapper in this process.
LAUNCHES: collections.Counter = collections.Counter()
# "build" (nvcc ran) and "load" (the library was opened) in this process.
LIBRARY_EVENTS: collections.Counter = collections.Counter()
_launches_lock = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    # keys, out, n, seed, table_size, threads, stream
    "murmur_bucket": (_P, _P, _I64, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, _P),
    # keys, bucket (null: none), fp (null: none), n, lanes, seed, fp_seed,
    # table_size, threads, stream
    "murmur_hash": (
        _P, _P, _P, _I64, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_int, _P,
    ),
    # bins, n, hist, num_bins, threads, stream
    "bin_histogram": (_P, _I64, _P, ctypes.c_int, ctypes.c_int, _P),
    # offsets, starts, table, table_len (rows), cols, vals, rows, capacity,
    # num_rows, fill, threads, stream
    "csr_gather": (
        _P, _P, _P, _I64, ctypes.c_int, _P, _P, _I64, *(ctypes.c_int,) * 3, _P,
    ),
    # ... as csr_gather, with num_sources before fill
    "csr_gather_batched": (
        _P, _P, _P, _I64, ctypes.c_int, _P, _P, _I64, *(ctypes.c_int,) * 4, _P,
    ),
    # slot_incl, starts, counts, layer_tables (L x 3 int64 on the card),
    # num_layers, num_owners, num_sources, num_rows, cols, seg, dropped,
    # seg_capacity, fill, threads, stream
    "csr_gather_owners": (
        _P, _P, _P, _P, *(ctypes.c_int,) * 5, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P,
    ),
    # incl, starts, table, table_rows, cols, vals, rows, offsets_out, dropped,
    # capacity, num_rows, num_queriers, fill, threads, stream
    "csr_gather_queriers": (
        _P, _P, _P, _I64, ctypes.c_int, _P, _P, _P, _P, _I64, *(ctypes.c_int,) * 4, _P,
    ),
    # starts, ends, q, table, n, table_len, num_shards, max_probe, lanes,
    # threads, out, stream
    "bucket_probe": (_P, _P, _P, _P, _I64, _I64, *(ctypes.c_int,) * 4, _P, _P),
    # rq, rh, lo, match_e (null: none), offsets, keys, n, keys_len, num_shards,
    # table_size, stride, epoch, max_probe, accumulate, lanes, threads, total,
    # stream
    "bucket_probe_layer": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, *(ctypes.c_int,) * 8, _P, _P,
    ),
    # q, k, v, o, the (batch, head, row) strides of each, nb, hq, sq, skv, d,
    # group, causal, window, scale, is_bf16, stream
    "flash_attention": (
        _P, _P, _P, _P, *(_I64,) * 12, *(ctypes.c_int,) * 8, ctypes.c_float, ctypes.c_int, _P,
    ),
    # d, is_bf16 (a query, not a launch: the block's dynamic shared memory)
    "flash_attention_smem_bytes": (ctypes.c_int, ctypes.c_int),
    # pre, its 4 strides, r, r_bf16, c0, n0, h0, m0, hs, its 3 strides,
    # cf, nf, hf, mf, xbuf, counters (f32 r only; null for bf16), batch,
    # heads, seq, hd, stream
    "slstm_sequence": (
        _P, _I64, _I64, _I64, _I64, _P, ctypes.c_int, _P, _P, _P, _P,
        _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, *(ctypes.c_int,) * 4, _P,
    ),
    # hd, r_bf16, batch, heads, out int[8] (a query, not a launch: the plan)
    "slstm_plan": (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources in parallel and link the shared library.

    A no-op when the library for the current sources exists.  The link goes
    to a temporary name and is renamed into place, so processes building at
    the same time never load a half-written file.  ``ptxas -v`` (registers,
    shared memory, spills per kernel) is kept in ``build.log`` beside the
    library.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = work / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)
        )
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    LIBRARY_EVENTS["build"] += 1
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _lib = lib
            LIBRARY_EVENTS["load"] += 1
    return _lib


def stream_of(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if its launch failed, else count it."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} (error {code})")
    with _launches_lock:
        LAUNCHES[name] += 1
    counting.record_launch(name)


def on_card(name: str, tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain twin); any other device is refused."""
    if tensor.device.type == "cpu":
        return False
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensor.device}")
    return True


def require_cuda(name: str, *tensors) -> None:
    """Wrapper-side checks shared by every kernel: one CUDA device, contiguity."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
