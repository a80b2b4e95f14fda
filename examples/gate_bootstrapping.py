"""Batched NAND gate bootstrapping (BASELINE config 4: NAND via blind
rotation, TFHE-style params).

Run on the CPU:  JAX_PLATFORMS=cpu python examples/gate_bootstrapping.py
(on a GPU machine, drop JAX_PLATFORMS and it runs on the card)
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from poulpy_tpu.binfhe import gates
from poulpy_tpu.hal.source import Source


def main():
    # toy-sized for a quick demo; production sizing is GateParams() defaults
    params = gates.GateParams(
        n_glwe=128, n_lwe=32, base2k=17, k_ct=34, k_brk=68,
        dnum_brk=4, k_ksk=51, dnum_ksk=2, nprimes=4,
    )
    keys, sk = gates.keygen(params)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)

    b1 = np.array([0, 0, 1, 1])
    b2 = np.array([0, 1, 0, 1])
    c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
    c2 = gates.encrypt_bit(params, b2, sk, xe, xa)
    out = gates.gate_nand(keys, c1, c2)   # one batched blind rotation
    got = gates.decrypt_bit(out, sk)
    print("NAND truth table:", dict(zip(zip(b1, b2), got)))
    assert np.array_equal(got, 1 - (b1 & b2))


if __name__ == "__main__":
    main()
