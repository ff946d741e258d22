"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library; bind with ctypes.

Every kernel source has a plain C interface (device pointers, ints and the
stream, returning ``cudaGetLastError()``), so it compiles without PyTorch's
headers in seconds.  The sources compile in parallel, one ``nvcc`` each, for
``sm_90a``; the objects link into one ``.so`` under
``build/repro_torch_kernels/<hash of sources and flags>/`` at the root of
the checkout.  The build runs at the first kernel launch on a CUDA tensor:
importing this module needs no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load", "launch", "build_dir"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# tiles, rows, cols, x, tables, partial, y, nnzb, n_row_blocks, block,
# piece, max_pieces, stream
_SPMV = [_P] * 7 + [_I] * 5 + [_P]
# C entry points: argument types in order (every one returns a cudaError_t)
SIGNATURES = {
    "bsr_spmv_f32": _SPMV,
    "bsr_spmv_bf16": _SPMV,
    # vals, local_ids, chunk_block, tables, partial, out, n_chunks,
    # n_out_blocks, chunk, piece, max_pieces, stream
    "segment_sum_chunked": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # tiles (f32), t_ij, t_ik, t_kj, out, n_triples, block, stream
    "bsr_tricount_wmma": [_P, _P, _P, _P, _P, _I, _I, _P],
    # tiles (fp16), t_ij, t_ik, t_kj, runs, out, n_triples, nnzb, block,
    # stream
    "bsr_tricount_sm90": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, out, B, Sq, Sk, H, D, causal, stream
    "flash_attention_fwd_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention_fwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention_fwd_bf16_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# wall seconds of the build this process ran (None: none ran, or it was cached)
build_seconds: Optional[float] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    # the toolkit's default install location when nvcc is not on PATH
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Directory keyed by the sources' and headers' contents and the
    compiler flags."""
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=out.parent))
    try:
        jobs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out.parent / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / out.name),
             *(str(obj) for _, obj, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp / out.name, out)   # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call if its hash is not on disk."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = build_dir() / "librepro_torch_kernels.so"
            if not path.exists():
                t0 = time.perf_counter()
                _compile(path)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch reported a CUDA error."""
    lib = load()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
