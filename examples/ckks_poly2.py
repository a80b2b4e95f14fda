"""Leveled CKKS: evaluate p(x) = x² + x + 1 on encrypted slots
(mirror of poulpy-ckks/examples/poly2.rs, BASELINE config 5).

Run on the CPU:  JAX_PLATFORMS=cpu python examples/ckks_poly2.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from poulpy_tpu.ckks import ops as ck
from poulpy_tpu.ckks.encoder import Encoder
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.prepared import glwe_secret_prepare, glwe_tensor_key_prepare
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.source import Source


def main():
    n, base2k = 128, 17
    k_ct, k_key = 119, 119
    log_delta, log_budget = 22, 30

    module = Module(n, nprimes=4)
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sk = enc.secret_new(module, 1, src)
    skp = glwe_secret_prepare(module, sk)
    tsk = glwe_tensor_key_prepare(
        module,
        enc.glwe_tensor_key_encrypt_sk(
            module, sk, skp, base2k, k_key, dnum=7, source_xe=xe, source_xa=xa
        ),
    )
    encoder = Encoder(n)

    rng = np.random.default_rng(1)
    x = rng.normal(size=n // 2) * 0.5 + 1j * rng.normal(size=n // 2) * 0.5

    pt = ck.encode(encoder, x, base2k, k_ct, log_delta, log_budget)
    ct = ck.encrypt_sk(module, pt, skp, k_ct, xe, xa)

    one = ck.encode(encoder, np.ones(n // 2), base2k, k_ct, log_delta,
                    log_budget - log_delta)
    sq = ck.mul(module, ct, ct, tsk)            # x²   (budget -= delta)
    acc = ck.add(sq, ct)                        # x² + x (aligns budgets)
    acc = ck.add_plain(acc, ck.encode(
        encoder, np.ones(n // 2), base2k, k_ct, log_delta, acc.log_budget))
    got = ck.decode(encoder, ck.decrypt(module, acc, skp))
    want = x * x + x + 1
    print("max error:", np.abs(got - want).max())
    assert np.abs(got - want).max() < 1e-3


if __name__ == "__main__":
    main()
