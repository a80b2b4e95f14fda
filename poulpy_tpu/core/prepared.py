"""Prepared (DFT-domain) layouts (poulpy-core/src/layouts/prepared/).

Preparation moves keys into the NTT domain once so the hot path does only
pointwise products and contractions:
  GLWESecretPrepared     svp  [rank, P, N]                      (Montgomery)
  GGLWEPrepared          pmat [dnum, rank_in, rank_out+1, size, P, N]
  GGSWPrepared           pmat [dnum, rank+1, rank+1, size, P, N]
  GLWEAutomorphismKeyPrepared / GLWESwitchingKeyPrepared: GGLWEPrepared (+p)
  GLWETensorKeyPrepared: rank(rank+1)/2 switching keys for the s_i·s_j terms
"""

from __future__ import annotations

import jax.numpy as jnp

from poulpy_tpu.core.layouts import GGLWECiphertext, GGSWCiphertext, GLWESecret
from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import Module
from poulpy_tpu.utils import struct


def _static(**kw):
    return struct.field(pytree_node=False, **kw)


@struct.dataclass
class GLWESecretPrepared:
    data: jnp.ndarray  # [rank, P, N] Montgomery NTT
    dist: str = _static(default="ternary_prob")

    @property
    def rank(self) -> int:
        return self.data.shape[-3]


@struct.dataclass
class GGLWEPrepared:
    pmat: jnp.ndarray  # [dnum, rank_in, rank_out+1, size, P, N]
    base2k: int = _static()
    k: int = _static()
    dsize: int = _static(default=1)

    @property
    def dnum(self) -> int:
        return self.pmat.shape[-6]

    @property
    def rank_in(self) -> int:
        return self.pmat.shape[-5]

    @property
    def rank_out(self) -> int:
        return self.pmat.shape[-4] - 1

    @property
    def size(self) -> int:
        return self.pmat.shape[-3]


@struct.dataclass
class GGSWPrepared:
    pmat: jnp.ndarray  # [dnum, rank+1, rank+1, size, P, N]
    base2k: int = _static()
    k: int = _static()
    dsize: int = _static(default=1)

    @property
    def dnum(self) -> int:
        return self.pmat.shape[-6]

    @property
    def rank(self) -> int:
        return self.pmat.shape[-4] - 1

    @property
    def size(self) -> int:
        return self.pmat.shape[-3]


@struct.dataclass
class GLWEAutomorphismKeyPrepared:
    key: GGLWEPrepared
    p: int = _static()  # the Galois element (layouts/glwe_automorphism_key.rs:56)


@struct.dataclass
class GLWETensorKeyPrepared:
    """Relinearization keys: keys[(i, j)] switches s_i·s_j → s
    (layouts/glwe_tensor_key.rs:45)."""

    keys: dict[tuple[int, int], GGLWEPrepared]


def glwe_secret_prepare(module: Module, sk: GLWESecret) -> GLWESecretPrepared:
    """SvpPrepare of every secret column (encryption stack 3.1, SURVEY.md)."""
    return GLWESecretPrepared(data=dft.svp_prepare(module, sk.data), dist=sk.dist)


def gglwe_prepare(module: Module, ct: GGLWECiphertext) -> GGLWEPrepared:
    return GGLWEPrepared(
        pmat=dft.vmp_prepare(module, ct.data),
        base2k=ct.base2k,
        k=ct.k,
        dsize=ct.dsize,
    )


def glwe_tensor_key_prepare(module: Module, keys: dict) -> GLWETensorKeyPrepared:
    return GLWETensorKeyPrepared(
        keys={k: gglwe_prepare(module, v) for k, v in keys.items()}
    )


def ggsw_prepare(module: Module, ct: GGSWCiphertext) -> GGSWPrepared:
    return GGSWPrepared(
        pmat=dft.vmp_prepare(module, ct.data),
        base2k=ct.base2k,
        k=ct.k,
        dsize=ct.dsize,
    )
