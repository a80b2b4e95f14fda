"""CKKS plaintext forms + multi-operand products.

Demonstrates the four plaintext representations of the reference
(poulpy-ckks/src/layouts/plaintext/) and the balanced-tree mul_many:
  * VecRnx — float coefficient polynomial, quantized on the fly for ct×pt
  * CstRnx/CstZnx — scalar constants, incl. an imaginary part riding the
    X^{N/2} rotation
  * mul_many — product of 4 ciphertexts at tree depth 2 (2·Δ budget,
    not 3·Δ)

Run on the CPU:
  JAX_PLATFORMS=cpu python examples/ckks_plaintext_forms.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from poulpy_tpu.ckks import ops as ck
from poulpy_tpu.ckks import plaintext as ptf
from poulpy_tpu.ckks.encoder import Encoder
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.prepared import glwe_secret_prepare, glwe_tensor_key_prepare
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source


def main():
    n, base2k, k_ct, k_key = 64, 17, 153, 153
    delta, budget = 18, 60
    m = get_module(n, 4)
    sk = enc.secret_new(m, 1, Source(bytes(32)))
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(
        m, sk, skp, base2k, k_key, dnum=9, source_xe=xe, source_xa=xa))
    encd = Encoder(n)
    rng = np.random.default_rng(0)

    def enc_ct(z):
        pt = ck.encode(encd, z, base2k, k_ct, delta, budget)
        return ck.encrypt_sk(m, pt, skp, k_ct, xe, xa)

    def dec(ct):
        return ck.decode(encd, ck.decrypt(m, ct, skp))

    # 1) VecRnx: float poly from the encoder, ct×pt via convolution
    z1, z2 = (rng.normal(size=n // 2) + 1j * rng.normal(size=n // 2)
              for _ in range(2))
    rnx = ptf.CKKSPlaintextVecRnx(coeffs=jnp.asarray(encd.encode_rnx(z2)))
    meta = ck.CKKSMeta(log_delta=delta, log_budget=8)
    out = ptf.mul_plain_rnx(m, enc_ct(z1), rnx, meta)
    print("VecRnx ct×pt err:", np.abs(dec(out) - z1 * z2).max())

    # 2) complex scalar constant (im rides X^{N/2})
    cst = ptf.CKKSPlaintextCstRnx(re=0.3, im=-1.25)
    out = ptf.mul_cst_rnx(m, enc_ct(z1), cst,
                          ck.CKKSMeta(log_delta=20, log_budget=0))
    print("CstRnx ct×(0.3-1.25i) err:",
          np.abs(dec(out) - z1 * (0.3 - 1.25j)).max())

    # 3) mul_many: 4-operand balanced tree
    zs = [0.5 * (rng.normal(size=n // 2) + 1j * rng.normal(size=n // 2))
          for _ in range(4)]
    prod = ck.mul_many(m, [enc_ct(z) for z in zs], tsk)
    want = zs[0] * zs[1] * zs[2] * zs[3]
    print("mul_many(4) err:", np.abs(dec(prod) - want).max(),
          "budget left:", prod.log_budget)


if __name__ == "__main__":
    main()
