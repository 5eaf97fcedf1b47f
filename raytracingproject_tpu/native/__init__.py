"""Native C++ host components, loaded via ctypes (no pybind11 in the
image; ref: the reference's C++ host core).

The shared library is compiled with g++ on first use, on the machine
that runs it, into `<repo>/build/native/` (listed in .gitignore). Its
file name carries a hash of the sources and the compiler command, so a
changed source or flag builds a new library and a stale one is never
loaded. The flags name no host CPU (no -march=native), so a library
built on one x86-64 host also runs on another. A NumPy fallback exists
for every native path, so the renderer works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from raytracingproject_tpu.utils import log

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                         "build", "native")
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
_LIB = None
_LOCK = threading.Lock()
_FAILED = False


def _sources():
    return sorted(os.path.join(_HERE, f) for f in os.listdir(_HERE)
                  if f.endswith(".cpp"))


def build_key(sources, flags=CXXFLAGS):
    """Hash of the sources' bytes and the compiler flags: the library's
    name, so any change to either builds a fresh library."""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        h.update(os.path.basename(s).encode() + b"\0")
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile_lib():
    srcs = _sources()
    out = os.path.join(BUILD_DIR, f"librtp_native-{build_key(srcs)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXXFLAGS, *srcs, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def get_lib():
    """Load (compiling if needed) the native library; None if unavailable."""
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        try:
            path = _compile_lib()
            lib = ctypes.CDLL(path)
            lib.rtp_build_bvh.restype = ctypes.c_int
            lib.rtp_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ]
            lib.rtp_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError) as e:
            log.log_warning("native lib unavailable (%s); using NumPy "
                            "fallbacks", e)
            _FAILED = True
    return _LIB


def build_bvh_native(lo, hi, max_leaf_size=4):
    """C++ SAH build; returns (bounds, children, prim_order) or None."""
    lib = get_lib()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = len(lo)
    out_bounds = ctypes.POINTER(ctypes.c_float)()
    out_children = ctypes.POINTER(ctypes.c_int32)()
    out_nnodes = ctypes.c_int32()
    out_order = ctypes.POINTER(ctypes.c_int32)()
    rc = lib.rtp_build_bvh(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, max_leaf_size,
        ctypes.byref(out_bounds), ctypes.byref(out_children),
        ctypes.byref(out_nnodes), ctypes.byref(out_order))
    if rc != 0:
        return None
    nn = out_nnodes.value
    bounds = np.ctypeslib.as_array(out_bounds, (nn, 12)).copy()
    children = np.ctypeslib.as_array(out_children, (nn, 2)).copy()
    order = np.ctypeslib.as_array(out_order, (max(n, 1),))[:n].copy()
    lib.rtp_free(out_bounds)
    lib.rtp_free(out_children)
    lib.rtp_free(out_order)
    return bounds, children, order
