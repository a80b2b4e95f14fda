"""Ciphertext / key layouts (poulpy-core/src/layouts/).

All layouts are pytree dataclasses (utils/struct.py): array leaves carry the limb data (and
batch over leading axes), static fields carry the parameter metadata the
reference encodes in its `*Infos` traits (GLWELayout, GGLWELayout, …,
poulpy-core/src/layouts/glwe.rs:36, gglwe.rs:37, ggsw.rs:38).

Shape conventions (leading `...` axes = batch):
  GLWE           data [..., rank+1, size, N]      (col 0 = body)
  GLWEPlaintext  data [..., size, N]
  GGLWE          data [..., dnum, rank_in, rank_out+1, size, N]
  GGSW           data [..., dnum, rank+1, rank+1, size, N]
  LWE            data [..., size, n_lwe+1]        (coeff 0 = body,
                   poulpy-core/src/layouts/lwe.rs:80 packs body+mask in one
                   degree-(n+1) row)
  GLWESecret     data [rank, N]

Prepared (DFT-domain) counterparts live in core/prepared.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from poulpy_tpu.utils import struct


def _static(**kw):
    return struct.field(pytree_node=False, **kw)


@struct.dataclass
class GLWECiphertext:
    data: jnp.ndarray
    base2k: int = _static()
    k: int = _static()

    @property
    def rank(self) -> int:
        return self.data.shape[-3] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def batch_shape(self):
        return self.data.shape[:-3]


@struct.dataclass
class GLWEPlaintext:
    data: jnp.ndarray
    base2k: int = _static()
    k: int = _static()

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


@struct.dataclass
class GGLWECiphertext:
    """Gadget GLWE: dnum rows × rank_in input cols of GLWE rows
    (poulpy-core/src/layouts/gglwe.rs:86); row r, col i encrypts
    pt_i · 2^{-(r·dsize+dsize)·base2k} (encryption/gglwe.rs:131-143)."""

    data: jnp.ndarray
    base2k: int = _static()
    k: int = _static()
    dsize: int = _static(default=1)

    @property
    def dnum(self) -> int:
        return self.data.shape[-5]

    @property
    def rank_in(self) -> int:
        return self.data.shape[-4]

    @property
    def rank_out(self) -> int:
        return self.data.shape[-3] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


@struct.dataclass
class GGSWCiphertext:
    """Gadget GSW: dnum × (rank+1) × (rank+1) (layouts/ggsw.rs:90); row r,
    col j encrypts m·s_j·2^{-(r·dsize+dsize)·base2k} with s_0 = 1
    (encryption/ggsw.rs)."""

    data: jnp.ndarray
    base2k: int = _static()
    k: int = _static()
    dsize: int = _static(default=1)

    @property
    def dnum(self) -> int:
        return self.data.shape[-5]

    @property
    def rank(self) -> int:
        return self.data.shape[-3] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


@struct.dataclass
class LWECiphertext:
    """Scalar LWE packed as body+mask in one row (layouts/lwe.rs:50-80)."""

    data: jnp.ndarray  # [..., size, n_lwe+1]
    base2k: int = _static()
    k: int = _static()

    @property
    def n_lwe(self) -> int:
        return self.data.shape[-1] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]


@struct.dataclass
class GLWESecret:
    """Secret key: one single-limb poly per rank column
    (layouts/glwe_secret.rs:38)."""

    data: jnp.ndarray  # [rank, N]
    dist: str = _static(default="ternary_prob")

    @property
    def rank(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


# Short aliases used throughout
GLWE = GLWECiphertext
GGLWE = GGLWECiphertext
GGSW = GGSWCiphertext
LWE = LWECiphertext


def glwe_size(base2k: int, k: int) -> int:
    """#limbs = ceil(k / base2k) (layouts/lwe.rs LWEInfos::size)."""
    return -(-k // base2k)
