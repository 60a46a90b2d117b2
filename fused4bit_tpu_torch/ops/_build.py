"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled by ``nvcc`` for ``sm_90a``, one ``nvcc`` per source,
all started together, and linked into one shared library with a plain C
interface, loaded with :mod:`ctypes`. The build runs at first
use (the first kernel launch, or an explicit :func:`library` call) into
``fused4bit_tpu_torch/_build/``; the library's file name carries a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one is
loaded as it is. Nothing here includes PyTorch's headers: the C functions
take raw pointers and the CUDA stream as ``void*`` and return
``cudaGetLastError()`` as an int.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

__all__ = ["library", "library_path", "check", "launch", "stream_of", "BUILD_DIR", "CSRC"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types; every pointer and the stream are
# void*, every size an int (K15's softmax scale a float), and each returns a
# cudaError_t as an int.
_SIGNATURES = {
    # x, packed, scales, zps, y, partial; M, N, K, ws, kw, splits, mt; stream
    "f4b_int4_matmul_bf16": [_P] * 6 + [_I] * 7 + [_P],
    "f4b_int4_matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, gids, packed, scales, zps, used, y, partial; T, N, K, (gs,) tile_m, ws, kw, splits, mt
    "f4b_grouped_int4_matmul_mma_bf16": [_P] * 8 + [_I] * 8 + [_P],
    "f4b_grouped_int4_matmul_pg_mma_bf16": [_P] * 8 + [_I] * 9 + [_P],
    "f4b_grouped_int4_matmul_planar_pg_mma_bf16": [_P] * 8 + [_I] * 9 + [_P],
    "f4b_grouped_int4_matmul_f32": [_P] * 7 + [_I] * 4 + [_P],
    # x, gids, packed, scales, zps, used, (xsum,) y; T, N, K, E, (gs,) tile_m, grid
    "f4b_grouped_int4_matmul_wg_bf16": [_P] * 7 + [_I] * 6 + [_P],
    "f4b_grouped_int4_matmul_pg_wg_bf16": [_P] * 8 + [_I] * 7 + [_P],
    # q, kp, ks, kz, vp, vs, vz, lengths, starts, out, partial; B, Hkv, G, Tq, S, D, QT, seg
    "f4b_int4_attention_bf16": [_P] * 11 + [_I] * 10 + [_P],
    "f4b_int4_attention_f32": [_P] * 10 + [_I] * 9 + [_P],
    # ..., table, lengths, starts, out, partial; B, Hkv, G, Tq, page, max_pages, D, QT, seg
    "f4b_paged_int4_attention_bf16": [_P] * 12 + [_I] * 10 + [_P],
    "f4b_paged_int4_attention_f32": [_P] * 11 + [_I] * 9 + [_P],
    # x, xq, sx, sums, used; M, K, gsum, fused; stream (K4, K5, K8, K10, K11, K14)
    "f4b_a8_prepass_bf16": [_P] * 5 + [_I] * 4 + [_P],
    "f4b_a8_prepass_f32": [_P] * 5 + [_I] * 4 + [_P],
    # xq, sx, sums, used, gids, packed, scales, zps, y, partial;
    # M, N, K, (gs,) tile_m, out_f32, ws, kw, splits; stream (gids NULL: K4, K5, K8)
    "f4b_grouped_int4_matmul_a8_mma": [_P] * 10 + [_I] * 8 + [_P],
    "f4b_grouped_int4_matmul_pg_a8_mma": [_P] * 10 + [_I] * 9 + [_P],
    "f4b_int4_matmul_pg_bf16": [_P] * 5 + [_I] * 4 + [_P],
    "f4b_int4_matmul_pg_f32": [_P] * 5 + [_I] * 4 + [_P],
    "f4b_int4_matmul_pg_a8_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "f4b_int4_matmul_pg_a8_f32": [_P] * 6 + [_I] * 4 + [_P],
    "f4b_grouped_int4_matmul_pg_bf16": [_P] * 7 + [_I] * 5 + [_P],
    "f4b_grouped_int4_matmul_pg_f32": [_P] * 7 + [_I] * 5 + [_P],
    "f4b_grouped_int4_matmul_pg_a8_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "f4b_grouped_int4_matmul_pg_a8_f32": [_P] * 8 + [_I] * 5 + [_P],
    # x, packed, scales, zps, y, partial; M, N, K, gs, ws, kw, splits, mt; stream
    "f4b_int4_matmul_planar_pg_bf16": [_P] * 6 + [_I] * 8 + [_P],
    "f4b_int4_matmul_pg_mma_bf16": [_P] * 6 + [_I] * 8 + [_P],
    # x, packed, scales, zps, y, partial; M, N, K, (gs,) full, splits, grid; stream
    "f4b_int4_matmul_wg_bf16": [_P] * 6 + [_I] * 6 + [_P],
    "f4b_int4_matmul_pg_wg_bf16": [_P] * 6 + [_I] * 7 + [_P],
    "f4b_int4_matmul_planar_pg_f32": [_P] * 5 + [_I] * 4 + [_P],
    "f4b_grouped_int4_matmul_planar_pg_f32": [_P] * 7 + [_I] * 5 + [_P],
    # x, gids, packed, scales, zps, rows_used, partial, y; T, N, K, tile_m, splits
    "f4b_grouped_int4_matmul_ksplit_f32": [_P] * 8 + [_I] * 5 + [_P],
    # q_lat, q_pe, packed, scale, zp, k_pe, lengths, starts, out, partial;
    # B, T, H, S, q_lat and q_pe strides, out strides, seg, Z; softmax scale
    "f4b_mla_attention_bf16": [_P] * 10 + [_I] * 12 + [_F, _P],
    # stream, since, id, last, count: the nodes a capturing stream added after
    # `since` (a host function, no kernel; utils/profiling.py's layer spans)
    "f4b_capture_nodes_since": [_P] * 5,
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cus + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_log() -> str:
    """The compiler's output (ptxas registers, shared memory, spills) of the
    library :func:`library` loads; empty before the first build."""
    log = BUILD_DIR / f"libfused4bit_{_digest()}.log"
    return log.read_text() if log.exists() else ""


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def library_path() -> pathlib.Path:
    """The file of the kernel library built from the sources as they are."""
    return BUILD_DIR / f"libfused4bit_{_digest()}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library, once per
    process."""
    digest = _digest()
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cus, _ = _sources()
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs = [pathlib.Path(tmpdir) / f"{cu.stem}.o" for cu in cus]
            with ThreadPoolExecutor(max_workers=len(cus)) as pool:
                logs = list(pool.map(
                    _run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)]
                           for cu, o in zip(cus, objs)]))
            tmp = pathlib.Path(tmpdir) / so.name
            logs.append(_run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
            (BUILD_DIR / f"libfused4bit_{digest}.log").write_text("".join(logs))
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.f4b_error_string.argtypes = [_I]
    lib.f4b_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().f4b_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(on: torch.Tensor, name: str, *args, what: str = "") -> None:
    """Call the C entry point ``name`` on ``on``'s device and current stream:
    each tensor among ``args`` passed as its data pointer (None as NULL), the
    stream last; raise if it returned a CUDA error, named ``what`` (by
    default ``name``)."""
    with torch.cuda.device(on.device):
        err = getattr(library(), name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream_of(on))
    check(err, what or name)
