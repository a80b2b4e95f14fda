"""Lookup tables for blind rotation (poulpy-bin-fhe/src/blind_rotation/lut.rs).

A LUT encodes f: Z_{2N·ext} → T as `extension_factor` limb-vector
polynomials; `set` replicates each of the f_len function samples over
step = N·ext/f_len consecutive coefficients, scales them to the requested
torus precision, and pre-rotates by half a step (the `drift`) so rounding in
mod-switch lands mid-window.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from poulpy_tpu.hal.normalization import vec_znx_normalize
from poulpy_tpu.hal.vec_znx import vec_znx_rotate, vec_znx_switch_ring
from poulpy_tpu.utils import struct


@struct.dataclass
class LookupTable:
    """data: [ext, size, N]; rot_dir "left" rotates by X^{-dec(lwe)}
    (standard), "right" by X^{+dec(lwe)} (lut.rs:17-33).  A pytree so
    blind rotation jits over it."""

    data: jnp.ndarray
    base2k: int = struct.field(pytree_node=False)
    k: int = struct.field(pytree_node=False)
    drift: int = struct.field(pytree_node=False, default=0)
    rot_dir: str = struct.field(pytree_node=False, default="left")

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def extension_factor(self) -> int:
        return self.data.shape[0]

    @property
    def domain_size(self) -> int:
        return self.n * self.extension_factor

    @property
    def size(self) -> int:
        return self.data.shape[-2]


def lookup_table_new(
    n: int,
    base2k: int,
    k: int,
    f,
    f_k: int,
    extension_factor: int = 1,
    rot_dir: str = "left",
) -> LookupTable:
    """Build a LUT from integer samples f at precision f_k
    (lookup_table_set, lut.rs:271-341)."""
    f = np.asarray(f, dtype=np.int64)
    size = -(-k // base2k)
    limbs = -(-f_k // base2k)
    domain = n * extension_factor
    assert len(f) <= domain

    scale = 1
    if f_k % base2k != 0:
        scale <<= base2k - (f_k % base2k)

    step = (domain + len(f) // 2) // len(f)
    lut_full = np.zeros((size, domain), dtype=np.int64)
    for i, fi in enumerate(f):
        lut_full[limbs - 1, i * step : (i + 1) * step] = fi * scale
    drift = step >> 1

    if extension_factor > 1:
        polys = []
        cur = jnp.asarray(lut_full)
        for i in range(extension_factor):
            polys.append(vec_znx_switch_ring(n, cur))
            cur = vec_znx_rotate(-1, cur)
        data = jnp.stack(polys, axis=0)
    else:
        data = jnp.asarray(lut_full)[None]

    data = vec_znx_normalize(base2k, data)
    lut = LookupTable(data=data, base2k=base2k, k=k, drift=drift, rot_dir=rot_dir)
    return lookup_table_rotate(lut, -drift)


def lookup_table_rotate(lut: LookupTable, k: int) -> LookupTable:
    """Rotate the (multi-poly) LUT by X^k (lookup_table_rotate,
    lut.rs:342-365)."""
    ext = lut.extension_factor
    two_n_ext = 2 * lut.n * ext
    k_pos = k % two_n_ext
    k_hi, k_lo = divmod(k_pos, ext)
    parts = []
    for i in range(ext):
        amt = k_hi + (1 if i >= ext - k_lo else 0)
        parts.append(vec_znx_rotate(amt, lut.data[i]))
    data = jnp.stack(parts, axis=0)
    data = jnp.roll(data, k_lo, axis=0)
    return LookupTable(
        data=data, base2k=lut.base2k, k=lut.k, drift=lut.drift, rot_dir=lut.rot_dir
    )
