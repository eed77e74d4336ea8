"""Build and load the port's hand-written CUDA kernels.

The sources under ``bitdance_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` (one process per source, all at once) and linked into ONE shared
library with a plain C interface, at first use, into ``build/`` at the root
of the checkout, named by a hash of the sources
and flags (a changed source builds a new library; an unchanged one is
reused). The library is bound with ``ctypes``: every pointer and the stream
travel as ``c_void_p``, and each C entry returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "bd_decode_attention": [_P] * 9,
    "bd_decode_attention_fusedkv": [_P] * 9,
    "bd_decode_blocks_per_sm": [_I],
    "bd_w4a8_matmul": [_P] * 9,
    "bd_fused_em_sample": ([_P, _P, _P, _I, _P, _P, _F] + [_P] * 17
                           + [_I] * 12 + [_F, _I] + [_P] * 7 + [_I, _P, _I, _P]),
    "bd_head_gemm": [_P] * 8,
    "bd_head_gemm_block": [_P] * 8,
    "bd_head_gemm_net": [_P] * 8,
    "bd_head_gemm_s8": [_P] * 10,
    "bd_fused_diffnet_forward": [_P] * 32 + [_I] * 12 + [_P, _I, _P],
    "bd_fused_mlp_block": ([_P, _P, _I, _P, _I, _P, _I] + [_P] * 9 + [_I] * 3
                           + [_F, _P, _I, _P]),
    "bd_fused_attn_block": ([_P, _P, _I, _P, _I, _P, _I] + [_P] * 9 + [_I] * 4
                            + [_F, _P, _I, _P]),
    "bd_flash_fwd": [_P] * 9 + [_I] * 6 + [_F, _P],
    "bd_flash_bwd_dq": [_P] * 11 + [_I] * 6 + [_F, _P],
    "bd_flash_bwd_dkv": [_P] * 12 + [_I] * 6 + [_F, _P],
    "bd_flash_fwd_sparse": [_P] * 11 + [_I] * 7 + [_F, _P],
    "bd_flash_bwd_dq_sparse": [_P] * 13 + [_I] * 7 + [_F, _P],
    "bd_flash_bwd_dkv_sparse": [_P] * 14 + [_I] * 7 + [_F, _P],
    "bd_fused_encode_tail": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbitdance_kernels_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        log.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(log[-1])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *[str(o) for o, _ in jobs]],
            capture_output=True, text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(log[-1])
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "".join(log)
    if failed:   # the failing sources' own output, not the others' ptxas lines
        raise RuntimeError("nvcc failed:\n" + "".join(failed)[-6000:])
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(build_info["log"])


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _build(so)
    else:
        build_info.setdefault("seconds", 0.0)
    build_info["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
        raise RuntimeError(f"{name}: CUDA error {code} on {msg}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (asked once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr() -> int:
    """The current device's current CUDA stream as an int, from the raw
    accessor PyTorch's generated code uses (a Stream object costs several
    microseconds of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def needs_grad(*tensors) -> bool:
    """True when autograd would want a backward through these inputs.

    The inference kernels (decode attention, the sampler, the head blocks)
    have no backward; their CUDA branch refuses such inputs (pure predicate,
    so the CPU tests can hold it). The flash-attention kernels have theirs."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or with inputs that do not require grad")
