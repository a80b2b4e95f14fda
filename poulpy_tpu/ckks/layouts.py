"""CKKS ciphertext/plaintext layouts (poulpy-ckks/src/layouts/)."""

from __future__ import annotations

from poulpy_tpu.core.layouts import GLWECiphertext, GLWEPlaintext
from poulpy_tpu.utils import struct


def _static(**kw):
    return struct.field(pytree_node=False, **kw)


@struct.dataclass
class CKKSMeta:
    """log_delta: scale bits; log_budget: remaining headroom bits.
    effective_k = log_delta + log_budget (poulpy-ckks/src/lib.rs:87-89)."""

    log_delta: int = _static()
    log_budget: int = _static()

    @property
    def effective_k(self) -> int:
        return self.log_delta + self.log_budget


@struct.dataclass
class CKKSCiphertext:
    glwe: GLWECiphertext
    meta: CKKSMeta

    @property
    def log_delta(self) -> int:
        return self.meta.log_delta

    @property
    def log_budget(self) -> int:
        return self.meta.log_budget

    @property
    def effective_k(self) -> int:
        return self.meta.effective_k


@struct.dataclass
class CKKSPlaintext:
    pt: GLWEPlaintext
    meta: CKKSMeta
