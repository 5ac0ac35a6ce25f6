"""Build and load the port's CUDA kernels (`src/repro_torch/csrc`).

Each `.cu` source compiles with `nvcc` into its own shared library with
a plain C interface, loaded through `ctypes`. Sources include no
PyTorch header, so a build takes seconds; all of them compile at once,
one `nvcc` process each, at the first kernel launch (never at import:
the CPU tests import every module). Libraries land in
`build/torch_kernels/` under the checkout, named by a hash of the
sources and flags, so an edited source is never served stale.

Flags: `sm_90a` (Hopper), `-O3`, and `--fmad=false`, so `a*b+c` is
never contracted into an FMA behind the kernels' explicit rounded
intrinsics: each kernel must equal its plain PyTorch version bitwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("nary_accum", "histogram", "quant", "dare", "ties", "slerp",
           "flash_attention", "flash_attention_bwd")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures: every function returns a cudaError_t as int
SIGNATURES: Dict[str, Tuple[str, List]] = {
    "nary_accum_f32": ("nary_accum", [_P, _P, _P, _P, _I, _L, _P]),
    "nary_accum_bf16": ("nary_accum", [_P, _P, _P, _P, _I, _L, _P]),
    "block_amax_f32": ("histogram", [_P, _P, _P, _I, _L, _I, _P]),
    "block_amax_bf16": ("histogram", [_P, _P, _P, _I, _L, _I, _P]),
    "block_hist_f32": ("histogram", [_P, _P, _P, _P, _P, _I, _L, _I, _I,
                                     _P]),
    "block_hist_bf16": ("histogram", [_P, _P, _P, _P, _P, _I, _L, _I, _I,
                                      _P]),
    # k, bins -> plan[3]: B4's warps per block, group, shared bytes
    "block_hist_plan": ("histogram", [_I, _I, _P]),
    "ties_block_f32": ("histogram", [_P, _P, _P, _P, _I, _L, _I, _P]),
    "ties_block_bf16": ("histogram", [_P, _P, _P, _P, _I, _L, _I, _P]),
    "quant_nary": ("quant", [_P, _P, _P, _P, _P, _I, _L, _I, _P]),
    "dare_block_f32": ("dare", [_P, _P, _P, _P, _I, _L, _I, _F, _F, _P]),
    "dare_block_bf16": ("dare", [_P, _P, _P, _P, _I, _L, _I, _F, _F, _P]),
    "ties_leaf_f32": ("ties", [_P, _P, _P, _P, _I, _L, _P]),
    "ties_leaf_bf16": ("ties", [_P, _P, _P, _P, _I, _L, _P]),
    "slerp_reduce_f32": ("slerp", [_P, _P, _P, _L, _I, _P]),
    "slerp_reduce_bf16": ("slerp", [_P, _P, _P, _L, _I, _P]),
    "slerp_combine_f32": ("slerp", [_P, _P, _P, _P, _L, _P]),
    "slerp_combine_bf16": ("slerp", [_P, _P, _P, _P, _L, _P]),
    # q, k, v, out, B, Sq, Sk, H, HK, D, 9 strides, scale, causal,
    # q_offset, softcap, window, stream
    "flash_attention_f32": ("flash_attention",
                            [_P] * 4 + [_I] * 6 + [_L] * 9
                            + [_F, _I, _I, _F, _I, _P]),
    "flash_attention_bf16": ("flash_attention",
                             [_P] * 4 + [_I] * 6 + [_L] * 9
                             + [_F, _I, _I, _F, _I, _P]),
    # ... then lse [B, H, Sq] fp32 (the prefill design, q_offset 0)
    "flash_attention_lse_f32": ("flash_attention",
                                [_P] * 4 + [_I] * 6 + [_L] * 9
                                + [_F, _I, _I, _F, _I, _P, _P]),
    "flash_attention_lse_bf16": ("flash_attention",
                                 [_P] * 4 + [_I] * 6 + [_L] * 9
                                 + [_F, _I, _I, _F, _I, _P, _P]),
    # B9's gradient: q, k, v, o, dout, lse, dd scratch, dq, dk, dv, B,
    # Sq, Sk, H, HK, D, scale, causal, softcap, window, stream
    "flash_attention_bwd_f32": ("flash_attention_bwd",
                                [_P] * 10 + [_I] * 6 + [_F, _I, _F, _I, _P]),
    "flash_attention_bwd_bf16": ("flash_attention_bwd",
                                 [_P] * 10 + [_I] * 6
                                 + [_F, _I, _F, _I, _P]),
    # kernel (0 dK / dV, 1 dQ), bf16, D -> the gradient's dynamic
    # shared-memory bytes (reports)
    "flash_attention_bwd_smem": ("flash_attention_bwd", [_I] * 3),
    # design, bf16, D, rows -> dynamic shared-memory bytes (reports)
    "flash_attention_smem": ("flash_attention", [_I] * 4),
    # ... then rows per block, splits, chunk, fp32 scratch, int32
    # tickets, stream
    "flash_decode_f32": ("flash_attention",
                         [_P] * 4 + [_I] * 6 + [_L] * 9
                         + [_F, _I, _I, _F] + [_I] * 4 + [_P] * 3),
    "flash_decode_bf16": ("flash_attention",
                          [_P] * 4 + [_I] * 6 + [_L] * 9
                          + [_F, _I, _I, _F] + [_I] * 4 + [_P] * 3),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once.
    Returns {source: compiler output} (ptxas register and shared-memory
    report) for the sources built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs: Dict[str, str] = {}
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def function(symbol: str):
    """The C entry point `symbol`, loading (and if need be building) its
    library on first use. Cached: a decode step calls B9 once a layer,
    and the host sets that step's pace."""
    fn = _FUNCS.get(symbol)
    if fn is not None:
        return fn
    lib_name, argtypes = SIGNATURES[symbol]
    if lib_name not in _LIBS:
        path = _lib_path(lib_name)
        if not path.exists():
            build_all()
        _LIBS[lib_name] = ctypes.CDLL(str(path))
    fn = getattr(_LIBS[lib_name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _FUNCS[symbol] = fn
    return fn


def on_host(*tensors, contiguous: bool = True) -> bool:
    """True when the operands lie on the CPU (the wrapper then runs its
    plain version); False when they all lie on one CUDA device and, if
    `contiguous`, are contiguous (the wrapper launches its kernel; a
    kernel that reads through strides checks its own layout). Anything
    else raises: a kernel input is never moved or copied behind the
    caller's back."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("operands on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if contiguous and not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel operands must be contiguous")
    return False


def check(code: int, symbol: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        lib = _LIBS[SIGNATURES[symbol][0]]
        lib.merge_error_string.restype = ctypes.c_char_p
        lib.merge_error_string.argtypes = [ctypes.c_int]
        msg = lib.merge_error_string(code).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} ({code})")
