"""Native host-side kernel library (C++ via ctypes).

The device compute path is XLA; the host-side runtime around it is
native, mirroring the reference's split (poulpy-cpu-ref's reference kernels
are the native tier under the Rust HAL).  kernels.cpp implements the
poulpy-cpu-ref twin: ChaCha8 keystream, znx coefficient kernels,
carry-propagation normalization, Montgomery NTT, and the exact __int128
negacyclic-convolution oracle used by the test suite.

Build model: compiled on demand with g++ into a cache directory keyed by
the source hash (no pip/pybind dependency — plain ctypes over an extern-"C"
surface).  Every entry point has a pure-Python/numpy fallback elsewhere in
the package; `available()` gates all uses, so environments without a
toolchain lose speed, not correctness.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "kernels.cpp")


@functools.lru_cache(maxsize=1)
def _lib():
    """Compile (if needed) and load the shared library; None on failure."""
    if os.environ.get("POULPY_NATIVE") == "0":
        return None
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src).hexdigest()[:16]
        cache_dir = os.environ.get(
            "POULPY_NATIVE_CACHE",
            os.path.join(tempfile.gettempdir(), "poulpy_tpu_native"),
        )
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"kernels_{tag}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".build{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
    except (OSError, subprocess.CalledProcessError):
        return None

    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64

    lib.chacha8_blocks.argtypes = [u32p, u64, u64, u32p]
    lib.znx_rotate_i64.argtypes = [i64, i64p, i64p, i64, i64]
    lib.znx_automorphism_i64.argtypes = [i64, i64p, i64p, i64, i64]
    lib.vec_znx_normalize_i64.argtypes = [i64, i64, i64p, i64, i64]
    lib.negacyclic_conv_i128.argtypes = [i64p, i64p, i64p, u64p, i64]
    lib.negacyclic_conv_i128_batch.argtypes = [i64p, i64p, i64p, u64p,
                                               i64, i64]
    lib.ntt_forward_i64.argtypes = [i64p, i64, i64, i64p, i64, i64]
    lib.ntt_inverse_i64.argtypes = [i64p, i64, i64, i64, i64p, i64, i64]
    for fn in (lib.chacha8_blocks, lib.znx_rotate_i64,
               lib.znx_automorphism_i64, lib.vec_znx_normalize_i64,
               lib.negacyclic_conv_i128, lib.negacyclic_conv_i128_batch,
               lib.ntt_forward_i64, lib.ntt_inverse_i64):
        fn.restype = None
    return lib


def available() -> bool:
    return _lib() is not None


# ---------------------------------------------------------------------------
# numpy-facing wrappers (all return fresh arrays; inputs never mutated)
# ---------------------------------------------------------------------------

def chacha8_blocks(key_words: np.ndarray, counter0: int,
                   nblocks: int) -> np.ndarray:
    """[nblocks, 16] uint32 keystream words, == hal.source._chacha_blocks
    for contiguous counters."""
    out = np.empty((nblocks, 16), dtype=np.uint32)
    _lib().chacha8_blocks(
        np.ascontiguousarray(key_words, np.uint32), counter0, nblocks,
        out.reshape(-1),
    )
    return out


def znx_rotate(p: int, a: np.ndarray) -> np.ndarray:
    """a·X^p in Z[X]/(X^N+1), [..., N] int64 (hal.znx.znx_rotate twin)."""
    a = np.ascontiguousarray(a, np.int64)
    n = a.shape[-1]
    out = np.empty_like(a)
    _lib().znx_rotate_i64(int(p), a.reshape(-1, n), out.reshape(-1, n),
                          a.size // n, n)
    return out


def znx_automorphism(p: int, a: np.ndarray) -> np.ndarray:
    """a(X^p) in Z[X]/(X^N+1) (hal.znx.znx_automorphism twin)."""
    a = np.ascontiguousarray(a, np.int64)
    n = a.shape[-1]
    out = np.empty_like(a)
    _lib().znx_automorphism_i64(
        int(p) & (2 * n - 1), a.reshape(-1, n), out.reshape(-1, n),
        a.size // n, n,
    )
    return out


def vec_znx_normalize(base2k: int, a: np.ndarray, lsh: int = 0) -> np.ndarray:
    """Carry-propagation normalization of [..., size, N] int64
    (hal.normalization.vec_znx_normalize twin)."""
    a = np.ascontiguousarray(a, np.int64)
    size, n = a.shape[-2], a.shape[-1]
    out = a.copy()
    flat = out.reshape(-1, size, n)
    for i in range(flat.shape[0]):
        _lib().vec_znx_normalize_i64(base2k, lsh, flat[i], size, n)
    return out


def negacyclic_conv_i128(a: np.ndarray, b: np.ndarray):
    """Exact a ⊛ b in Z[X]/(X^N+1) with __int128 accumulation.

    Returns (hi, lo): int64/uint64 arrays [..., N] encoding the signed
    128-bit results.  Caller must guarantee N·max|a|·max|b| < 2^127.
    """
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    n = a.shape[-1]
    assert b.shape == a.shape
    rows = a.size // n
    hi = np.empty(a.shape, dtype=np.int64)
    lo = np.empty(a.shape, dtype=np.uint64)
    _lib().negacyclic_conv_i128_batch(
        a.reshape(-1, n), b.reshape(-1, n),
        hi.reshape(-1, n), lo.reshape(-1, n), rows, n,
    )
    return hi, lo


def negacyclic_mul_exact(a, b) -> list[int]:
    """Exact negacyclic product of two int coefficient lists (oracle-grade).

    Uses the native __int128 kernel when the result provably fits, else
    raises OverflowError (callers fall back to the Python big-int loop).
    """
    a_arr = np.asarray(list(a), dtype=np.int64)
    b_arr = np.asarray(list(b), dtype=np.int64)
    n = a_arr.size
    bound = (
        n
        * max(1, int(np.max(np.abs(a_arr))))
        * max(1, int(np.max(np.abs(b_arr))))
    )
    if bound >= 1 << 126:
        raise OverflowError("result may exceed i128 range")
    hi, lo = negacyclic_conv_i128(a_arr, b_arr)
    return [(int(h) << 64) | int(l) for h, l in zip(hi, lo)]


def ntt_forward(psi_mont: np.ndarray, p: int, qinv: int,
                x: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT for one prime (hal.ntt.ntt_forward twin).

    psi_mont: [N] Montgomery bit-reversed-psi table (hal.ntt._host_tables
    row); x: [..., N] residues in [0, p)."""
    x = np.ascontiguousarray(x, np.int64)
    n = x.shape[-1]
    out = x.copy()
    _lib().ntt_forward_i64(
        np.ascontiguousarray(psi_mont, np.int64), p, qinv,
        out.reshape(-1, n), x.size // n, n,
    )
    return out


def ntt_inverse(psi_inv_mont: np.ndarray, ninv_mont: int, p: int, qinv: int,
                x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int64)
    n = x.shape[-1]
    out = x.copy()
    _lib().ntt_inverse_i64(
        np.ascontiguousarray(psi_inv_mont, np.int64), ninv_mont, p, qinv,
        out.reshape(-1, n), x.size // n, n,
    )
    return out
