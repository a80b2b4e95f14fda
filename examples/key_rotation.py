"""Evaluation-key management: re-encrypting gadget keys under a fresh
secret without decrypting — the round-3 key-rotation surface
(poulpy-core keyswitching/gglwe.rs + ggsw.rs, automorphism/gglwe_atk.rs).

Scenario: a server holds evaluation material under secret s1 (a GGSW
selector and an automorphism-key set).  The client rotates to a fresh
secret s2; the server converts every key with ONE public switching-key
bundle, never seeing a plaintext:

  * GGSW keyswitch:  GGSW_s1(m) → GGSW_s2(m) (col-0 keyswitch + tensor-key
    row expansion)
  * ATK composition: ATK(p1) ∘ ATK(p2) → ATK(p1·p2) — building a full
    Galois-key set from a few generators.

Run on the CPU:
  JAX_PLATFORMS=cpu python examples/key_rotation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from poulpy_tpu import Module, Source
from poulpy_tpu.core import decryption as dec
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.automorphism import (
    glwe_automorphism,
    glwe_automorphism_key_automorphism,
)
from poulpy_tpu.core.conversion import gglwe_to_ggsw_key_encrypt_sk
from poulpy_tpu.core.external_product import glwe_external_product
from poulpy_tpu.core.keyswitching import ggsw_keyswitch
from poulpy_tpu.core.layouts import GLWEPlaintext
from poulpy_tpu.core.prepared import (
    GLWEAutomorphismKeyPrepared,
    gglwe_prepare,
    ggsw_prepare,
    glwe_secret_prepare,
)
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.znx import znx_automorphism, znx_rotate

N, BASE2K, K_CT, K_KEY = 64, 17, 51, 102
m = Module(N, 4)
xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)

sk1 = enc.secret_new(m, 1, Source(b"\x0a" * 32))
sk1p = glwe_secret_prepare(m, sk1)
sk2 = enc.secret_new(m, 1, Source(b"\x0b" * 32))
sk2p = glwe_secret_prepare(m, sk2)

# --- GGSW keyswitch: server-side key rotation of a selector -----------------
sel = np.zeros(N, dtype=np.int64)
sel[5] = 1                                   # GGSW(X^5): rotate-by-5 action
ggsw_s1 = enc.ggsw_encrypt_sk(
    m, jnp.asarray(sel), sk1p, BASE2K, 68, dnum=3, source_xe=xe, source_xa=xa
)
ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
    m, sk1, sk2p, BASE2K, K_KEY, dnum=6, source_xe=xe, source_xa=xa
))
tsk = gglwe_to_ggsw_key_encrypt_sk(
    m, sk2, sk2p, BASE2K, K_KEY, dnum=6, source_xe=xe, source_xa=xa
)
ggsw_s2 = ggsw_keyswitch(m, ggsw_s1, ksk, tsk)

data = np.arange(N, dtype=np.int64) * 17 - 400
pt = GLWEPlaintext(
    data=vec_znx.encode_vec_i64(BASE2K, 34, 3, jnp.asarray(data)),
    base2k=BASE2K, k=34,
)
ct2 = enc.glwe_encrypt_sk(m, pt, sk2p, BASE2K, K_CT, xe, xa)
out = glwe_external_product(m, ct2, ggsw_prepare(m, ggsw_s2))
got = np.asarray(vec_znx.decode_vec_i64(
    BASE2K, 34, dec.glwe_decrypt(m, out, sk2p).data))
want = np.asarray(znx_rotate(5, jnp.asarray(data)))
err = np.abs(got - want).max()
print(f"GGSW keyswitch s1→s2: selector still rotates by X^5, max err {err}")
assert err <= 1024

# --- ATK composition: a Galois-key set from one generator -------------------
p1 = m.galois_element(1)                     # 5
atk1, _ = enc.glwe_automorphism_key_encrypt_sk(
    m, p1, sk2, BASE2K, K_KEY, dnum=6, source_xe=xe, source_xa=xa
)
atk1_p = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, atk1), p=p1)
atk2, p2 = glwe_automorphism_key_automorphism(m, atk1, p1, atk1_p)
atk2_p = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, atk2), p=p2)
print(f"composed ATK({p1}) ∘ ATK({p1}) → ATK({p2})")

ct = enc.glwe_encrypt_sk(m, pt, sk2p, BASE2K, K_CT, xe, xa)
rot = glwe_automorphism(m, ct, atk2_p)
got = np.asarray(vec_znx.decode_vec_i64(
    BASE2K, 34, dec.glwe_decrypt(m, rot, sk2p).data))
want = np.asarray(znx_automorphism(p2, jnp.asarray(data)))
err = np.abs(got - want).max()
print(f"φ_{p2} via the composed key: max err {err}")
assert err <= 8
print("ok")
