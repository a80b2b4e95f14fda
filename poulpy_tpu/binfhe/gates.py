"""Boolean gate bootstrapping (TFHE-style NAND/AND/OR/XOR/NOT on LWE bits).

The reference exposes blind rotation + circuit bootstrapping as primitives
(no boolean-gate API); this module composes them into the classic gate
bootstrap the BASELINE targets ("NAND via blind rotation, TFHE-style
params"): linear combination on LWE → sign-LUT blind rotation → coefficient
extraction → keyswitch back to the LWE secret.

Bit encoding: b ↦ (2b−1)/8 on the torus (k = 3 bits).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from poulpy_tpu.binfhe.blind_rotation import (
    BlindRotationKeyPrepared,
    blind_rotation_execute,
    blind_rotation_key_encrypt_sk,
)
from poulpy_tpu.binfhe.lut import LookupTable
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.conversion import glwe_to_lwe_key_encrypt_sk, lwe_sample_extract
from poulpy_tpu.core.keyswitching import glwe_keyswitch
from poulpy_tpu.core.layouts import GLWECiphertext, LWECiphertext, glwe_size
from poulpy_tpu.core.prepared import GGLWEPrepared, glwe_secret_prepare
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.normalization import vec_znx_normalize
from poulpy_tpu.hal.source import Source


@dataclass(frozen=True)
class GateParams:
    """TFHE-style parameter set (defaults sized after the bin-fhe example,
    poulpy-bin-fhe/examples/bdd_arithmetic.rs:64-106)."""

    n_glwe: int = 1024
    n_lwe: int = 571
    base2k: int = 17
    k_ct: int = 34        # LWE/accumulator torus precision (2 limbs)
    k_brk: int = 68       # blind rotation key precision
    dnum_brk: int = 4
    k_ksk: int = 51       # GLWE→LWE switching key precision
    dnum_ksk: int = 2
    nprimes: int = 2
    prime_bits: int = 28  # 2 primes below 2^28 (56 bits) cover the exact
                          # range
    block_size: int = 1   # > 1 selects the block-binary CGGI path


@dataclass
class BootstrapKeys:
    module: Module
    params: GateParams
    brk: BlindRotationKeyPrepared
    to_lwe: GGLWEPrepared
    lut: LookupTable


def keygen(
    params: GateParams, seed: bytes = bytes(32)
) -> tuple[BootstrapKeys, np.ndarray]:
    """Generate (public bootstrap keys, LWE secret)."""
    module = Module(params.n_glwe, params.nprimes, params.prime_bits)
    src = Source(seed)
    xe, xa = src.branch()[1], src.branch()[1]
    if params.block_size > 1:
        sk_lwe = src.binary_block(params.n_lwe, params.block_size)
    else:
        sk_lwe = src.binary_prob((params.n_lwe,))
    sk_glwe = enc.secret_new(module, 1, src)
    sk_glwe_prep = glwe_secret_prepare(module, sk_glwe)

    brk = blind_rotation_key_encrypt_sk(
        module, jnp.asarray(sk_lwe), sk_glwe_prep,
        params.base2k, params.k_brk, params.dnum_brk, xe, xa,
    )
    to_lwe = glwe_to_lwe_key_encrypt_sk(
        module, jnp.asarray(sk_lwe), sk_glwe,
        params.base2k, params.k_ksk, params.dnum_ksk, xe, xa,
    )
    # sign LUT: constant 1/8 on every coefficient (drift-free); the
    # negacyclic wrap makes coefficient 0 of X^{-phase}·LUT equal ±1/8.
    size = glwe_size(params.base2k, params.k_ct)
    data = jnp.zeros((1, size, params.n_glwe), jnp.int64)
    data = data.at[0, 0, :].set(1 << (params.base2k - 3))
    lut = LookupTable(
        data=vec_znx_normalize(params.base2k, data),
        base2k=params.base2k,
        k=params.k_ct,
    )
    keys = BootstrapKeys(
        module=module, params=params, brk=brk, to_lwe=to_lwe, lut=lut
    )
    return keys, sk_lwe


def encrypt_bit(
    params: GateParams, bits, sk_lwe, source_xe: Source, source_xa: Source
) -> LWECiphertext:
    """b ↦ (2b−1)/8; `bits` may be a scalar or batch array."""
    bits = np.asarray(bits, dtype=np.int64)
    size = glwe_size(params.base2k, params.k_ct)
    pt = np.zeros(bits.shape + (size, 1), dtype=np.int64)
    pt[..., 0, 0] = (2 * bits - 1) << (params.base2k - 3)
    return enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe),
        params.base2k, params.k_ct, source_xe, source_xa,
    )


def decrypt_bit(ct: LWECiphertext, sk_lwe) -> np.ndarray:
    from poulpy_tpu.core.decryption import lwe_decrypt

    out = lwe_decrypt(ct, jnp.asarray(sk_lwe))
    return (np.asarray(out[..., 0]) > 0).astype(np.int64)


def _const_lwe(params: GateParams, num: int, den_log2: int, like: LWECiphertext):
    """Trivial LWE of num·2^{-den_log2} (body only)."""
    size = like.size
    data = jnp.zeros_like(like.data)
    data = data.at[..., 0, 0].set(num << (params.base2k - den_log2))
    return data


def _bootstrap(keys: BootstrapKeys, lin_data) -> LWECiphertext:
    """sign-LUT blind rotation + extract + keyswitch to the LWE secret."""
    params = keys.params
    lin = LWECiphertext(
        data=vec_znx_normalize(params.base2k, lin_data),
        base2k=params.base2k,
        k=params.k_ct,
    )
    if params.block_size > 1:
        from poulpy_tpu.binfhe.blind_rotation import blind_rotation_execute_block

        acc = blind_rotation_execute_block(
            keys.module, lin, keys.lut, keys.brk, params.block_size
        )
    else:
        acc = blind_rotation_execute(keys.module, lin, keys.lut, keys.brk)
    glwe = GLWECiphertext(
        data=acc, base2k=params.base2k, k=keys.lut.size * params.base2k
    )
    ks = glwe_keyswitch(keys.module, glwe, keys.to_lwe, params.base2k, params.k_ct)
    return lwe_sample_extract(ks, params.n_lwe, params.k_ct)


def gate_nand(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext):
    lin = _const_lwe(keys.params, 1, 3, c1) - c1.data - c2.data
    return _bootstrap(keys, lin)


def gate_and(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext):
    lin = -_const_lwe(keys.params, 1, 3, c1) + c1.data + c2.data
    return _bootstrap(keys, lin)


def gate_or(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext):
    lin = _const_lwe(keys.params, 1, 3, c1) + c1.data + c2.data
    return _bootstrap(keys, lin)


def gate_nor(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext):
    lin = -_const_lwe(keys.params, 1, 3, c1) - c1.data - c2.data
    return _bootstrap(keys, lin)


def gate_xor(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext):
    lin = _const_lwe(keys.params, 1, 2, c1) + 2 * (c1.data + c2.data)
    return _bootstrap(keys, lin)


def gate_xnor(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext):
    lin = -_const_lwe(keys.params, 1, 2, c1) - 2 * (c1.data + c2.data)
    return _bootstrap(keys, lin)


def gate_not(keys: BootstrapKeys, c1: LWECiphertext) -> LWECiphertext:
    return c1.replace(data=-c1.data)
