"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, which is
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
Each ``.cu`` file compiles in its own ``nvcc`` process, all started
together, and the objects link into ``_build/libpt_kernels_<hash>.so``,
keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the existing library.  ``_build/`` is listed
in ``.gitignore``.

Nothing here runs at import time: :func:`library` builds on its first
call.  A failed build raises :class:`KernelBuildError` with the
compiler's output; there is no fallback.

An engine warm-started from an artifact directory (``aot/serve.py``)
loads the artifact's copy of the library instead (:func:`load_library`),
after checking that the copy was built from these sources: a digest that
does not match is a manifest mismatch, never a silent rebuild.
:func:`build_stats` counts the ``nvcc`` processes this process started and
names the file it loaded.
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
from typing import Optional

__all__ = ["KernelBuildError", "KernelLaunchError", "LayerArgs",
           "FlashArgs", "LceArgs", "WoArgs", "NormArgs", "SoftmaxArgs",
           "library", "load_library", "library_path", "source_digest",
           "build_stats", "check", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

PT_F32, PT_BF16 = 0, 1
EPI_NONE, EPI_RESID, EPI_SWIGLU, EPI_SWIGLU_R = 0, 1, 2, 3
EPI_BIAS, EPI_BIAS_RESID, EPI_BIAS_GELU = 4, 5, 6
#: LayerArgs.wq: the layer's matmul weights in the model dtype, int8 codes,
#: or int4 codes halves-packed
WQ_NONE, WQ_INT8, WQ_INT4 = 0, 1, 2


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a non-zero ``cudaError_t``."""


class LayerArgs(ctypes.Structure):
    """Mirror of ``struct LayerArgs`` in ``csrc/common.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in
                 ("dtype", "M", "H", "Hq", "Hkv", "D", "F", "BS", "NB", "MB",
                  "start", "wq", "gs", "kv_quant", "norm", "ffn", "rope",
                  "fused_qkv", "bias")]
                + [("eps", ctypes.c_float), ("scale", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in
                   ("x", "ln1_w", "q_w", "k_w", "v_w", "o_w", "ln2_w",
                    "gate_w", "up_w", "down_w", "q_s", "k_s", "v_s", "o_s",
                    "gate_s", "up_s", "down_s", "ln1_b", "ln2_b", "qkv_w",
                    "qkv_b", "proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w",
                    "fc2_b", "qkv_s", "proj_s", "fc1_s", "fc2_s", "cos",
                    "sin", "block_table",
                    "lengths", "blk", "off", "pool_k", "pool_v", "pool_ks",
                    "pool_vs", "y", "q", "k", "v", "attn", "x_mid", "hbuf",
                    "out")])


class FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in ``csrc/common.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in
                 ("dtype", "B", "Sq", "Sk", "Hq", "Hkv", "D", "causal")]
                + [("bias_sb", ctypes.c_longlong),
                   ("bias_sh", ctypes.c_longlong), ("scale", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in
                   ("q", "k", "v", "dout", "delta", "bias", "seg_q", "seg_k",
                    "lse", "out", "dq", "dk", "dv")])


class LceArgs(ctypes.Structure):
    """Mirror of ``struct LceArgs`` in ``csrc/common.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in
                 ("x_dtype", "w_dtype", "T", "H", "V", "c0", "width", "ldz",
                  "has_ignore", "ignore_index", "first", "last")]
                + [("eps", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in
                   ("x", "w", "labels", "g", "nll", "lse", "dz_w", "dz_x",
                    "dx_acc", "dx", "dw", "part", "tickets", "xs")])


class WoArgs(ctypes.Structure):
    """Mirror of ``struct WoArgs`` in ``csrc/common.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in
                 ("int4", "x_dtype", "M", "K", "N", "half", "ldx", "xhi",
                  "gs", "G", "tile_dq", "epi", "qkv_d")]
                + [(n, ctypes.c_void_p) for n in ("x", "w", "scale", "y",
                                                  "R", "B")])


class NormArgs(ctypes.Structure):
    """Mirror of ``struct NormArgs`` in ``csrc/common.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in ("dtype", "R", "H")]
                + [("eps", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in
                   ("x", "res", "bias", "w", "b", "out", "add", "mean",
                    "inv")])


class SoftmaxArgs(ctypes.Structure):
    """Mirror of ``struct SoftmaxArgs`` in ``csrc/common.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in ("dtype", "mask_dtype", "S",
                                              "nd")]
                + [("R", ctypes.c_longlong),
                   ("size", ctypes.c_longlong * 4),
                   ("mstride", ctypes.c_longlong * 4),
                   ("mcol", ctypes.c_longlong)]
                + [(n, ctypes.c_void_p) for n in ("x", "mask", "out")])


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_nvcc_runs = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _sources():
    cu = sorted(CSRC.glob("*.cu"))
    if not cu:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    return cu, sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all, raise on any failure."""
    global _nvcc_runs
    _nvcc_runs += len(cmds)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(c)}\n{out}")
    if errors:
        raise KernelBuildError("CUDA kernel build failed:\n"
                               + "\n".join(errors))


def _build(so: Path, cu) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (f.stem + ".o") for f in cu]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(f), "-o", str(o)]
                  for f, o in zip(cu, objs)])
        tmp_so = Path(tmp) / so.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                   str(tmp_so)]])
        os.replace(tmp_so, so)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ptr = ctypes.POINTER(LayerArgs)
    fptr = ctypes.POINTER(FlashArgs)
    lptr = ctypes.POINTER(LceArgs)
    LL = ctypes.c_longlong
    nptr = ctypes.POINTER(NormArgs)
    sigs = {"pt_decode_block": [ptr, P], "pt_prefill_block": [ptr, P],
            "pt_flash_fwd": [fptr, P], "pt_flash_bwd_dq": [fptr, P],
            "pt_flash_bwd_dkv": [fptr, P],
            "pt_linear_ce_fwd": [lptr, P], "pt_linear_ce_dz": [lptr, P],
            "pt_linear_ce_scratch": [lptr, ctypes.POINTER(LL)],
            "pt_linear_ce_dx": [lptr, P], "pt_linear_ce_dw": [lptr, P],
            "pt_linear_ce_split_x": [lptr, P],
            "pt_rope_kv_write": [ptr, P], "pt_paged_attention": [ptr, P],
            "pt_rms_norm_rows": [I, I, I, P, P, P, Fl, P],
            "pt_layer_norm_rows": [I, I, I, P, P, P, P, Fl, P],
            "pt_gemm_xw": [I, I, I, I, I, P, P, P, P, P, P, I, P],
            "pt_decode_attention": [I, I, I, I, I, I, LL, LL, LL, Fl, P, P,
                                    P, P, P, P],
            "pt_weight_only_matmul": [ctypes.POINTER(WoArgs), P],
            "pt_wo_layer": [ctypes.POINTER(WoArgs), P],
            "pt_rms_norm_fwd": [nptr, P], "pt_layer_norm_fwd": [nptr, P],
            "pt_bias_residual_ln_fwd": [nptr, P],
            "pt_swiglu_fwd": [I, LL, P, P, P, P],
            "pt_rope_fwd": [I, LL, I, I, I, Fl, P, P, P, P, P],
            "pt_softmax_mask_fwd": [ctypes.POINTER(SoftmaxArgs), P],
            "pt_bias_act_fwd": [I, I, LL, I, P, P, P, P],
            "pt_dropout_add_fwd": [I, LL, I, Fl, Fl, P, P, P, P, P],
            "pt_launch_counts": [ctypes.POINTER(ctypes.c_longlong), I]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pt_reset_launch_counts.argtypes = []
    lib.pt_reset_launch_counts.restype = None


def source_digest() -> str:
    """The digest of the sources and flags a library is built from (the
    key of its file name under ``_build/``)."""
    cu, cuh = _sources()
    return _digest(cu + cuh)


def _load(so: Path) -> ctypes.CDLL:
    global _lib, _lib_path
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    _lib, _lib_path = lib, so
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with _lock:
        if _lib is None:
            so = BUILD_DIR / f"libpt_kernels_{source_digest()}.so"
            if not so.exists():
                _build(so, _sources()[0])
            _load(so)
        return _lib


def load_library(path, digest: str) -> ctypes.CDLL:
    """Make the library at ``path`` (an artifact's copy, built from
    sources of ``digest``) this process's library.  Raises
    ``aot.AotManifestMismatchError`` when ``digest`` is not that of these
    sources.  A process that has loaded a library already keeps it (it
    was built from these same sources)."""
    have = source_digest()
    if digest != have:
        from ..aot.artifact import AotManifestMismatchError
        raise AotManifestMismatchError(
            f"{path}: kernel library built from sources {digest}, these "
            f"sources are {have} — re-export")
    with _lock:
        return _lib if _lib is not None else _load(Path(path))


def library_path() -> Optional[Path]:
    """The file of the loaded library, None before the first load."""
    return _lib_path


def build_stats():
    """``{"nvcc_runs": nvcc processes this process started, "library":
    the loaded library's file or None}``."""
    return {"nvcc_runs": _nvcc_runs,
            "library": None if _lib_path is None else str(_lib_path)}


def check(code: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero ``cudaError_t``."""
    if code != 0:
        raise KernelLaunchError(f"{what} failed with cudaError_t {code}")
