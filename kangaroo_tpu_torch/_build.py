"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it.

The kernels have a plain C interface (pointers, sizes and the stream as
integers), so the library links against nothing of PyTorch and builds in
seconds; it is loaded with ``ctypes``. Each source compiles to an object in
its own ``nvcc`` process, all started together, and one more links them.
The build runs at first use, into
``_build/`` beside this file (listed in ``.gitignore``), under a name keyed
on a hash of the sources and headers (``csrc/*.cu``, ``*.cuh``), the
generated headers and the flags, so an edit to any of them rebuilds and an
unchanged tree reuses the library.

``host_library`` builds the host-side C++ of ``native/`` (the meshing
cores and the frame loader) the same way with ``g++``: one library a
source, keyed on its hash and the flags, published with ``os.replace`` so
that processes building the same key at once all load a whole file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NATIVE_DIR = PKG_DIR / "native"
# the JAX package's flags for the meshing cores, so they compute the same bits;
# -pthread for the frame loader's worker threads (the JAX package builds it so)
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# vol, vol_is_bf16, vol strides (d, y), img, img row stride, out, acc, out
# strides (d, y), D, S, N, sx, sy, sd, xoff, width, seam, P1, P2, carry in
# (prev, best, img, has), carry out (prev, best), stream
_SEGMENT = [_P, _I, _L, _L, _P, _L, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
            _P, _P, _P, _P, _P, _P, _P]
# vol, vol_is_bf16, last, out, D, H, W, sd, lam, theta, stream
_WTA_SQ = [_P, _I, _P, _P, _I, _I, _I, _I, _F, _F, _P]
# vol, vol_is_bf16, g, d, a, q, thetas (host), D, H, W, sd, lam, sigma_q,
# sigma_d, huber_alpha, iterations, stream
_DTAM = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P]
# g, lam_weight (or null), u, scratch, H, W, lam, sigma, tau, alpha, huber,
# iterations, stream
_ROF = [_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P]
# f, u, scratch, H, W, alpha0, alpha1, sigma, tau, delta, iterations, stream
_TGV = [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _I, _P]
# val, weight, gmd, gct, params, window, D, H, W, axis, gh, gw, Wi, Hi, stream
_FUSE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
# C entry points (csrc/*.cu) and their argument types; every entry returns
# cudaGetLastError() as an int
SIGNATURES = {
    # vol, vol_is_bf16, vol strides (d, y), img, img row stride, out, out
    # strides (d, y), D, S, N, sx, sy, sd, P1, P2, accumulate, stream
    "kt_sgm_path": [_P, _I, _L, _L, _P, _L, _P, _L, _L, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    # the segment kernel (csrc/sgm_path.cu), and the warp-per-line design it
    # is held against (csrc/sgm.cu)
    "kt_sgm_segment": _SEGMENT,
    "kt_sgm_segment_lines": _SEGMENT,
    # vol, vol_is_bf16, out, D, H, W, sd, stream
    "kt_wta_subpix": [_P, _I, _P, _I, _I, _I, _I, _P],
    # the median on tiles (csrc/median.cu): img, out, N, H, W, rad, max_bad,
    # stream; and the one-thread-per-pixel design it is held against: img,
    # out, H, W, rad, max_bad, stream
    "kt_median_reject_invalid": [_P, _P, _I, _I, _I, _I, _I, _P],
    "kt_median_reject_invalid_pixel": [_P, _P, _I, _I, _I, _I, _P],
    # the LR check on rows (csrc/lr_check.cu): disp_l, disp_r, out_l, out_r,
    # H, W, sd (0: both directions), max_diff, max_disp, stream; and the
    # one-thread-per-pixel design it is held against: disp_l, disp_r, out,
    # H, W, sd, max_diff, k_min, k_max, stream
    "kt_lr_check": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "kt_lr_check_pixel": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    # the ROF solve on tiles in shared memory (csrc/rof.cu), and the
    # two-launches-an-iteration design it is held against
    "kt_rof_denoise": _ROF,
    "kt_rof_denoise_steps": _ROF,
    # the TGV solve on tiles in shared memory (csrc/tgv.cu), and the
    # two-launches-an-iteration design it is held against
    "kt_tgv_denoise": _TGV,
    "kt_tgv_denoise_steps": _TGV,
    # the DTAM search (csrc/wta_sq.cu), and the one-thread-per-pixel design
    # it is held against
    "kt_wta_sq": _WTA_SQ,
    "kt_wta_sq_pixel": _WTA_SQ,
    # the DTAM alternation (csrc/dtam.cu), and the three-launch design it is
    # held against
    "kt_dtam_run": _DTAM,
    "kt_dtam_run_split": _DTAM,
    # the fuse on plane tiles (csrc/separable_fuse.cu), and the
    # voxel-per-thread design it is held against
    "kt_separable_fuse": _FUSE,
    "kt_separable_fuse_voxel": _FUSE,
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def generated_headers() -> dict[str, str]:
    """Headers written into the build directory before compiling."""
    from .ops import median_cuda

    return {"median_network.cuh": median_cuda.network_header()}


def _key(sources, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + list(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for name, text in sorted(headers.items()):
        h.update(name.encode())
        h.update(text.encode())
    return h.hexdigest()[:16]


def _compile() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = generated_headers()
    lib_path = BUILD_DIR / f"libkangaroo_kernels_{_key(sources, headers)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for name, text in headers.items():
            (Path(tmp) / name).write_text(text)
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        jobs = [([nvcc, *NVCC_FLAGS, "-I", tmp, "-I", str(CSRC_DIR), "-c", "-o", str(obj),
                  str(src)]) for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in jobs]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(jobs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}{proc.stderr}")
        lib_path.with_suffix(".log").write_text("".join(logs))
        # atomic publish: a concurrent build of the same key loses nothing
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The kernels' library, built on first call; raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


_host_libs: dict[str, ctypes.CDLL] = {}


def _compile_host(stem: str) -> Path:
    src = NATIVE_DIR / f"{stem}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: native/{src.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [gxx, *GXX_FLAGS, "-o", str(tmp_lib), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def host_library(stem: str) -> ctypes.CDLL:
    """``native/<stem>.cpp`` built with g++ on first call and loaded (the
    caller declares its functions' types); raises if the build fails."""
    with _lock:
        if stem not in _host_libs:
            _host_libs[stem] = ctypes.CDLL(str(_compile_host(stem)))
    return _host_libs[stem]
