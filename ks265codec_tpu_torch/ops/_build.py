"""Builds the port's CUDA kernels and counts their launches.

All `csrc/*.cu` sources go through ONE `torch.utils.cpp_extension.load`
call (ninja compiles them in parallel) for `sm_90a`, into
`build/ks265_torch_kernels/` at the repository root. The sources expose a
plain C interface and include no PyTorch header, so each compiles in
seconds; the library is loaded with ctypes. Every C entry point launches
on the stream it is given and returns `cudaGetLastError()` right after its
launch; `check()` raises on a nonzero code, which is this interface's form
of `C10_CUDA_KERNEL_LAUNCH_CHECK()`.

The build runs at the first launch, never at import. `--fmad=false` keeps
nvcc from contracting float32 multiply-adds on its own: the decision
kernels reproduce the reference's float32 sequence and write every fused
multiply-add they need explicitly (`__fmaf_rn`).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ks265_torch_kernels"
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false"]

# Launch counts per kernel, bumped by each wrapper where it launches.
launches: dict[str, int] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point: pointers, ints and floats, ending with
# the CUDA stream; all return a cudaError_t as int.
_SIGNATURES = {
    "ks_decide_pass_a": [_P] * 5 + [_I] * 5 + [_P],
    "ks_decide_pass_b": [_P] * 16 + [_I] * 6 + [_P],
    "ks_decide_nxn_a": [_P] * 4 + [_I] * 3 + [_P],
    "ks_decide_nxn_b": [_P] * 13 + [_I] * 3 + [_P],
    "ks_decide_split": [_P] * 7 + [_I] * 3 + [_P],
    "ks_intra_level": [_P] * 12 + [_I] * 6 + [_P],
    "ks_deblock_edges": [_P] * 6 + [_I] * 10 + [_P],
    "ks_intra_recon": [_P] * 9 + [_I] * 4 + [_P],
    "ks_sao_stats": [_P] * 6 + [_I] * 8 + [_P],
    "ks_sao_apply": [_P] * 6 + [_I] * 7 + [_P],
    "ks_la_downsample": [_P] * 2 + [_I] * 3 + [_P],
    "ks_la_features": [_P] * 3 + [_I] * 3 + [_P],
    "ks_la_var": [_P] * 2 + [_I] * 3 + [_P],
    "ks_me_down2": [_P] * 2 + [_I] * 3 + [_P],
    "ks_me_dense_l2": [_P] * 4 + [_I] * 4 + [_F, _P],
    "ks_me_refine3": [_P] * 3 + [_I] * 7 + [_P],
    "ks_me_subpel8": [_P] * 4 + [_I] * 5 + [_F, _P, _P],
    "ks_me_bi_cost8": [_P] * 5 + [_I] * 4 + [_F, _P],
    "ks_inter_decide_tier": [_P] * 29 + [_I] * 9 + [_P],
    "ks_inter_cand_sads": [_P] * 9 + [_I] * 8 + [_P],
    "ks_inter_mc": [_P] * 11 + [_I] * 9 + [_P],
    "ks_inter_tu_class": [_P] * 17 + [_I] * 7 + [_P],
    "ks_inter_gate": [_P] * 4 + [_I] * 2 + [_P],
    "ks_inter_finish": [_P] * 18 + [_I] * 6 + [_P],
    "ks_inter_bs": [_P] * 9 + [_I] * 3 + [_P],
    "ks_inter_eff_qp": [_P] * 8 + [_I] * 7 + [_P],
    "ks_sao_decide": [_P] * 16 + [_I] * 2 + [_F] * 3 + [_P],
    "ks_inter_recon": [_P] * 11 + [_I] * 3 + [_P],
    "ks_rdoq_sbh": [_P] * 6 + [_I] * 3 + [_P],
    "ks_me_full_grid": [_P] * 3 + [_I] * 3 + [_P],
    "ks_subpel_costs": [_P] * 3 + [_I] * 2 + [_P],
    "ks_subpel_bi_cost": [_P] * 6 + [_I] * 2 + [_P],
}

_lock = threading.Lock()
_lib = None


def count(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def reset_launches() -> None:
    launches.clear()


def kernels(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            from torch.utils.cpp_extension import load
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = load(name="ks265_torch_kernels",
                        sources=sorted(str(p) for p in CSRC.glob("*.cu")),
                        extra_include_paths=[str(CSRC)],
                        build_directory=str(BUILD_DIR),
                        extra_cuda_cflags=CUDA_FLAGS,
                        is_python_module=False, verbose=verbose)
            lib = ctypes.CDLL(path)
            for fn, args in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = args
                f.restype = ctypes.c_int
            lib.ks_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ks_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = _lib.ks_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
