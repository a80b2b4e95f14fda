"""Module: the per-ring-degree backend handle.

Equivalent of the reference `Module<B>` (poulpy-hal/src/layouts/module.rs:97-101)
= ring degree N + backend handle (twiddle tables).  Here the handle is a set
of device-resident NTT twiddle/CRT constant arrays for a chosen prime basis,
plus cached Galois permutations.  A Module is cheap to create per (N, basis)
and is captured as a closure constant by jitted pipelines.
"""

from __future__ import annotations

import functools

from poulpy_tpu.hal.ntt import NttTables
from poulpy_tpu.hal.primes import LOG_N_MAX, PrimeBasis, ntt_primes

GALOIS_GENERATOR = 5  # poulpy-hal/src/layouts/module.rs:214 (GALOISGENERATOR)


class Module:
    """Backend handle: ring degree + CRT-NTT tables.

    `nprimes` bounds the exact accumulation range (see
    `hal.primes.required_nprimes`); 4 primes (~120 bits) cover every
    reference benchmark configuration (N ≤ 2^16, base2k ≤ 26).
    """

    def __init__(self, n: int, nprimes: int = 4, prime_bits: int = 30):
        """`prime_bits` bounds the basis primes below 2^prime_bits.

        30 (default) maximizes bits-per-prime; 28 leaves two bits of
        headroom per residue (values in [0, 2p) ⊂ [0, 2^29)) for lazy
        reduction.  Validity asserts adapt automatically via
        `basis.modulus`.
        """
        assert n & (n - 1) == 0 and 4 <= n <= (1 << LOG_N_MAX)
        assert 18 <= prime_bits <= 30
        self.n = n
        self.log_n = n.bit_length() - 1
        self.basis = PrimeBasis(ntt_primes(nprimes, below=1 << prime_bits))
        self.tables = NttTables(self.basis, n)
        # mesh-aware backend handle (SURVEY §2.8: Module ↔ (mesh, N,
        # constants)): set via module_with_mesh, consulted by the public
        # entry points (parallel/auto.py)
        self.mesh = None
        self.batch_axis = "dp"
        self._local = self

    @property
    def local(self):
        """The mesh-less twin (self when no mesh is attached) — what ops
        re-enter with inside a shard_map region."""
        return self._local

    @property
    def nprimes(self) -> int:
        return self.basis.nprimes

    def max_base2k(self, log_rows: int = 7) -> int:
        """Largest base2k with guaranteed-exact VMP accumulation."""
        bits = self.basis.modulus.bit_length() - 1
        return (bits - self.log_n - log_rows - 2 + 2) // 2

    # -- Galois helpers (module.rs:214-258) --------------------------------

    def galois_element(self, generator_exp: int) -> int:
        """5^|exp| (or its inverse for negative exp) mod 2N."""
        two_n = 2 * self.n
        g = pow(GALOIS_GENERATOR, abs(generator_exp), two_n)
        if generator_exp < 0:
            g = pow(g, -1, two_n)
        return g

    def galois_element_inv(self, gal_el: int) -> int:
        return pow(gal_el, -1, 2 * self.n)

    def __repr__(self):
        return f"Module(n={self.n}, primes={self.basis.primes})"


@functools.lru_cache(maxsize=None)
def get_module(n: int, nprimes: int = 4, prime_bits: int = 30) -> Module:
    return Module(n, nprimes, prime_bits)


def module_with_mesh(module: Module, mesh, batch_axis: str = "dp") -> Module:
    """Mesh-attached twin of `module` sharing its tables: the public entry
    points then run batch-sharded over `mesh`'s `batch_axis` transparently
    (parallel/auto.py).  The twin is a distinct object, so jit caches never
    mix sharded and local traces (the module is the static cache key)."""
    m = object.__new__(Module)
    m.n = module.n
    m.log_n = module.log_n
    m.basis = module.basis
    m.tables = module.tables
    m.mesh = mesh
    m.batch_axis = batch_axis
    m._local = module.local
    return m
