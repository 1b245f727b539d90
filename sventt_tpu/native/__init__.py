"""Native host runtime: C++ golden oracle and field helpers via ctypes.

The compute path of the framework is JAX/XLA; this package carries
the host-side native components (the role the reference's C++ host code
plays outside the SVE kernels): an exact golden NTT oracle at native speed,
naive convolution, and table-companion helpers.  Built on first use from the
committed sources with the system C++ compiler (OpenMP when available) into
the git-ignored ``libsventt_host.so``; ``available()`` reports whether that
worked, and every entry point returns None when it did not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_SRCS = [
    os.path.join(_HERE, "host_golden.cc"),
    os.path.join(_HERE, "series.cc"),
]
_LIB = os.path.join(_HERE, "libsventt_host.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    """Compile the library, with OpenMP where the compiler has it."""
    for cc in ("c++", "g++"):
        for extra in (["-fopenmp"], []):
            try:
                r = subprocess.run(
                    [cc, "-O3", *extra, "-shared", "-fPIC", *_SRCS, "-o", _LIB],
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.TimeoutExpired):
                break
            if r.returncode == 0:
                return True
    return False


def _stale() -> bool:
    if not os.path.exists(_LIB):
        return True
    t = os.path.getmtime(_LIB)
    return any(os.path.getmtime(s) > t for s in _SRCS)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale():
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            # a committed/stale .so can be for another OS or arch (dlopen
            # fails even though the file exists); rebuild from source once
            # and retry before giving up the oracle
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError:
                return None
        u64 = ctypes.c_uint64
        p64 = ctypes.POINTER(ctypes.c_uint64)
        lib.sventt_powmod.restype = u64
        lib.sventt_powmod.argtypes = [u64, u64, u64]
        lib.sventt_invmod.restype = u64
        lib.sventt_invmod.argtypes = [u64, u64]
        lib.sventt_golden_forward.restype = ctypes.c_int
        lib.sventt_golden_forward.argtypes = [p64, u64, u64, u64]
        lib.sventt_golden_inverse.restype = ctypes.c_int
        lib.sventt_golden_inverse.argtypes = [p64, u64, u64, u64]
        lib.sventt_pointwise_mulmod.restype = ctypes.c_int
        lib.sventt_pointwise_mulmod.argtypes = [p64, p64, p64, u64, u64]
        lib.sventt_cyclic_convolve_naive.restype = ctypes.c_int
        lib.sventt_cyclic_convolve_naive.argtypes = [p64, p64, p64, u64, u64]
        lib.sventt_montgomery_inverse.restype = u64
        lib.sventt_montgomery_inverse.argtypes = [u64]
        lib.sventt_shoup_precompute.restype = u64
        lib.sventt_shoup_precompute.argtypes = [u64, u64]
        lib.sventt_qpochhammer.restype = ctypes.c_int
        lib.sventt_qpochhammer.argtypes = [p64, u64, u64, u64]
        lib.sventt_rp_create.restype = ctypes.c_void_p
        lib.sventt_rp_create.argtypes = [u64, u64]
        lib.sventt_rp_destroy.restype = None
        lib.sventt_rp_destroy.argtypes = [ctypes.c_void_p]
        lib.sventt_rp_next.restype = ctypes.c_int
        lib.sventt_rp_next.argtypes = [ctypes.c_void_p, p64, u64]
        lib.sventt_gauss_numerator_range.restype = ctypes.c_int
        lib.sventt_gauss_numerator_range.argtypes = [p64, u64, u64, u64, u64, u64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def golden_forward(data, modulus: int, generator: int):
    """Native golden DIF forward (bit-reversed out), or None if unavailable.

    ``data``: numpy uint64 array, canonical residues; returns a new array.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    from ..field.modulus import Modulus

    a = np.ascontiguousarray(np.asarray(data, dtype=np.uint64))
    m = a.shape[0]
    omega = Modulus(modulus, generator).get_root_forward(m)
    out = a.copy()
    rc = lib.sventt_golden_forward(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), m, modulus, omega
    )
    if rc != 0:
        raise ValueError("golden_forward failed (m must be a power of two)")
    return out


def pointwise_mul(a, b, modulus: int):
    """Native elementwise a*b mod N of canonical uint64 residues, or None."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    p64 = ctypes.POINTER(ctypes.c_uint64)
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    b = np.ascontiguousarray(np.asarray(b, dtype=np.uint64))
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError("pointwise_mul needs two 1-D arrays of one length")
    out = np.empty_like(a)
    lib.sventt_pointwise_mulmod(
        a.ctypes.data_as(p64), b.ctypes.data_as(p64), out.ctypes.data_as(p64),
        a.shape[0], modulus,
    )
    return out


def qpochhammer(k: int, degree: int, modulus: int):
    """Native coefficients [0..degree] of (q;q)_k mod N, or None.

    C++ analogue of reference gaussian-polynomial.hpp:19-45; mirrors
    apps.series.q_pochhammer_coeffs (the numpy model is the test oracle).
    """
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    out = np.empty(degree + 1, dtype=np.uint64)
    rc = lib.sventt_qpochhammer(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        degree + 1, k, modulus,
    )
    if rc != 0:
        raise ValueError("qpochhammer failed")
    return out


class RestrictedPartitionStream:
    """Streaming coefficients of 1/(q;q)_k with O(k^2) state.

    Native analogue of the reference's rolling-table RestrictedPartition
    (reference examples/magic-series/restricted-partition.hpp:37-50):
    ``next(count)`` returns the next ``count`` coefficients; memory stays
    bounded no matter how far the stream advances.  Usable as a context
    manager.  Returns None from the module factory when no compiler exists.
    """

    def __init__(self, k: int, modulus: int, _lib):
        self._lib = _lib
        self._h = _lib.sventt_rp_create(k, modulus)
        if not self._h:
            raise MemoryError("rp_create failed")
        self.k = k
        self.modulus = modulus
        self.position = 0

    def next(self, count: int):
        import numpy as np

        out = np.empty(count, dtype=np.uint64)
        rc = self._lib.sventt_rp_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), count
        )
        if rc != 0:
            raise ValueError("rp_next failed")
        self.position += count
        return out

    def close(self) -> None:
        if self._h:
            self._lib.sventt_rp_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def restricted_partition_stream(k: int, modulus: int):
    """RestrictedPartitionStream, or None if the native library is absent."""
    lib = _load()
    if lib is None:
        return None
    return RestrictedPartitionStream(k, modulus, lib)


def gauss_numerator_range(lo: int, count: int, n: int, k: int, modulus: int):
    """Coefficients [lo, lo+count) of prod_{i=n-k+1}^{n} (1 - q^i) mod N.

    Streams the numerator from its k+1 Rothe segments (reference
    gaussian-polynomial.hpp:52-146) -- O(k^2) work per overlapping segment,
    never materializing the full degree-r polynomial.  None if unavailable.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    out = np.empty(count, dtype=np.uint64)
    rc = lib.sventt_gauss_numerator_range(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lo, count, n, k, modulus,
    )
    if rc == 2:
        raise MemoryError("gauss_numerator_range: scratch allocation failed")
    if rc != 0:
        raise ValueError("gauss_numerator_range failed (requires k <= n)")
    return out


def golden_inverse(data, modulus: int, generator: int):
    """Native golden DIT inverse (natural order out), or None."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    from ..field.modulus import Modulus

    a = np.ascontiguousarray(np.asarray(data, dtype=np.uint64))
    m = a.shape[0]
    omega = Modulus(modulus, generator).get_root_forward(m)
    out = a.copy()
    rc = lib.sventt_golden_inverse(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), m, modulus, omega
    )
    if rc != 0:
        raise ValueError("golden_inverse failed (m must be a power of two)")
    return out
