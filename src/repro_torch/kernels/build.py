"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface (pointers, ints and the
stream as ``void*``; each entry returns ``cudaGetLastError()``), so no
PyTorch header is compiled and the whole build takes seconds. Sources
are compiled in parallel, one ``nvcc -c`` per file, for ``sm_90a``, then
linked into one shared library under ``build/repro_torch/<hash>/`` at
the repository root (listed in ``.gitignore``). The directory name is a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached library. Nothing is built at import
time: ``library()`` builds on the first kernel launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every entry point: (argtypes); all return int (a
# cudaError_t, bytes for the *_smem_bytes entries, a count for
# expert_score_max_clusters)
SIGNATURES = {
    # x, w1, b1, w2, b2, out, B, D, H, K, n_rank, rows, stream
    "expert_score_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P],
    # D, H, n_rank, rows -> dynamic shared memory bytes of one block
    "expert_score_smem_bytes": [_I, _I, _I, _I],
    # D, H, n_rank, rows -> clusters of n_rank blocks resident at once
    "expert_score_max_clusters": [_I, _I, _I, _I],
    # z, centroids, mask, expert (or null), out, cls (or null), R, K, M,
    # h, eps, stream
    "cosine_fine_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, q_pos, kv_pos, out, lse (or null), B, H, KV, S, dh, window,
    # scale, is_bf16, n_split, stream
    "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _F, _I, _I, _P],
    # q, k_pages, v_pages, table, q_pos, kv_pos, out, B, H, KV, n_lp, page,
    # page_stride, dh, window, scale, is_bf16, n_split, stream
    "paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _L, _I, _I, _F, _I, _I, _P],
    # S, n_lp, G, dh, is_bf16 -> dynamic shared memory bytes of one block
    "decode_attention_smem_bytes": [_I, _I, _I, _I, _I],
    # r, k, v, logw, u, state, o, out_state, B, H, P, is_bf16, stream
    "wkv_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
#: wall seconds the last build took (0.0 when a cached library loaded)
build_seconds: float = 0.0
#: ptxas register / shared-memory report of the last build
build_log: str = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel, then link; returns the log."""
    nvcc = _nvcc()
    cus, _ = _sources()
    procs = []
    for src in cus:
        obj = out_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    objs = [str(out_dir / (s.stem + ".o")) for s in cus]
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link\n{link.stdout}")
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    return "\n".join(log)


def _build() -> Path:
    global build_seconds, build_log
    final = BUILD_ROOT / _digest()
    lib = final / LIB_NAME
    if lib.exists():
        build_seconds = 0.0
        log = final / "build.log"
        build_log = log.read_text() if log.exists() else ""
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        build_log = _compile(tmp)
        (tmp / "build.log").write_text(build_log)
        try:
            os.rename(tmp, final)   # atomic publish
        except OSError:
            if not lib.exists():    # lost no race: a real failure
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shape, dtype and device, no
    storage): the dry run's. A wrapper gives back its outputs' shapes for
    one, launches nothing and counts nothing, and reports the launch's
    work to ``on_fake_launch``."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


#: called as ``on_fake_launch(name, flops)`` by a wrapper given fake
#: tensors, where it would have launched ``name``; the dry run's counter
#: sets it while it traces a step
on_fake_launch = None


def fake_launch(name: str, flops: float) -> None:
    if on_fake_launch is not None:
        on_fake_launch(name, flops)


def check_aligned(fn: str, **tensors) -> None:
    """Raise unless every tensor starts on 16 bytes (the kernels move
    these tensors as 16-byte vectors or copies)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start on 16 bytes (its "
                             f"address is {t.data_ptr() % 16} bytes past)")
