"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

At first use every ``csrc/*.cu`` source is compiled for ``sm_90a`` into its
own shared library with a plain C interface, all nvcc processes started
together.  The libraries land in ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an unchanged source
is never rebuilt.  A failed build raises with nvcc's error output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv, D, causal, window, softcap,
# scale, stream
_FLASH = [_P] * 6 + [_I] * 8 + [_F, _F, _P]
# q, k, v, q_pos, k_pos, out, m_ws, l_ws, acc_ws, B, L, Hkv, G, D, chunk,
# n_split, window, softcap, scale, stream
_DECODE = [_P] * 9 + [_I] * 8 + [_F, _F, _P]
# q, k_pool, v_pool, tables, q_pos, out, m_ws, l_ws, acc_ws, B, nb, bs, Hkv,
# pool_heads, head0, G, D, chunk, n_split, window, softcap, scale, stream
_PAGED = [_P] * 9 + [_I] * 11 + [_F, _F, _P]
# a, b, h0, h, agg_a, agg_b, B, S, W, chunk, n_chunks, stream
_LINREC = [_P] * 6 + [_I] * 5 + [_P]
# x, r, scale, s, y, rows, d, scale_f32, eps, stream
_RMSNORM = [_P] * 5 + [_I] * 3 + [_F, _P]
# x, out, rows, d, stream
_SUMSQ = [_P] * 2 + [_I] * 2 + [_P]
# x, stat, scale, y, rows, d, width, scale_f32, eps, stream
_STAT = [_P] * 4 + [_I] * 4 + [_F, _P]
SIGNATURES = {
    "flash_attention": {"flash_attention_bf16": _FLASH, "flash_attention_f32": _FLASH},
    "decode_attention": {"decode_attention_bf16": _DECODE,
                         "decode_attention_f32": _DECODE},
    "paged_decode_attention": {"paged_decode_attention_bf16": _PAGED,
                               "paged_decode_attention_f32": _PAGED},
    "linear_recurrence": {"linear_recurrence_f32": _LINREC},
    "rmsnorm": {"rmsnorm_bf16": _RMSNORM, "rmsnorm_f32": _RMSNORM,
                "rmsnorm_sumsq_bf16": _SUMSQ, "rmsnorm_sumsq_f32": _SUMSQ,
                "rmsnorm_stat_bf16": _STAT, "rmsnorm_stat_f32": _STAT},
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every stale source, in parallel; returns stem -> library."""
    libs = {src.stem: _library_path(src) for src in sorted(CSRC.glob("*.cu"))}
    stale = {stem: path for stem, path in libs.items() if not path.exists()}
    if not stale:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for stem, path in stale.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp)
    errors = []
    for stem, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, stale[stem])
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {stem}.cu (exit {proc.returncode}):\n{err}{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def stream(t) -> int:
    """The raw handle of the current CUDA stream on tensor ``t``'s device,
    the stream a launcher takes: the capturing stream inside a CUDA graph
    capture.  (``torch.cuda.current_stream`` builds a ``Stream`` object,
    several microseconds of host time a launch.)"""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.cache
def load() -> Dict[str, Callable[..., int]]:
    """Build if needed, load the libraries and return their launchers by
    name, each with its ctypes argument types set."""
    libs = build()
    fns: Dict[str, Callable[..., int]] = {}
    for stem, sigs in SIGNATURES.items():
        lib = ctypes.CDLL(str(libs[stem]))
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns
