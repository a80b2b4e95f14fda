"""Scale-out demo: the three mesh axes of poulpy_tpu.parallel.

The reference library is single-process (SURVEY.md §2.8); this example shows
the distribution layer on whatever devices are available — the GPUs of one
host, or a virtual CPU mesh for a laptop demo:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/scale_out.py

Axes (parallel/multihost.py docstring has the host/NVLink placement rules):
  dp — ciphertext batch (embarrassingly parallel; the only axis that may
       cross hosts): demonstrated with a batch of NAND gate bootstraps.
  tp — CRT primes (one all_gather per inverse transform): demonstrated
       with the (dp, tp)-sharded external product.
  sp — ring degree N (all_to_all per NTT stage, for N beyond one
       device's memory): demonstrated with the ring-sharded external
       product.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from poulpy_tpu.binfhe import gates
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.layouts import GLWEPlaintext, glwe_size
from poulpy_tpu.core.prepared import ggsw_prepare, glwe_secret_prepare
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source
from poulpy_tpu.parallel import (
    make_hybrid_mesh,
    shard_batch,
    sharded_external_product_fn,
    sharded_gate_bootstrap_fn,
)
from poulpy_tpu.utils.compile_cache import enable_compile_cache


def main():
    ndev = len(jax.devices())
    print(f"devices: {ndev} × {jax.devices()[0].platform}")

    # --- dp: batched NAND bootstraps sharded over all devices -------------
    params = gates.GateParams(
        n_glwe=64, n_lwe=8, base2k=17, k_ct=34, k_brk=68,
        dnum_brk=4, k_ksk=51, dnum_ksk=2, nprimes=4,
    )
    keys, sk = gates.keygen(params)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    bits1 = np.arange(2 * ndev) % 2
    bits2 = 1 - bits1
    c1 = gates.encrypt_bit(params, bits1, sk, xe, xa)
    c2 = gates.encrypt_bit(params, bits2, sk, xe, xa)
    mesh_dp = jax.make_mesh((ndev,), ("dp",))
    nand = sharded_gate_bootstrap_fn(keys, mesh_dp, "nand")
    out = nand(shard_batch(mesh_dp, c1.data), shard_batch(mesh_dp, c2.data))
    got = gates.decrypt_bit(c1.replace(data=out), sk)
    assert np.array_equal(got, 1 - (bits1 & bits2))
    print(f"dp: {2 * ndev} NAND bootstraps over {ndev} devices ✓")

    # --- (dp, tp): external product, primes sharded over tp --------------
    tp = 2 if ndev % 2 == 0 else 1
    mesh = make_hybrid_mesh(tp=tp)
    dp = ndev // tp
    base2k, k_ct, k_key = 17, 51, 68
    m = get_module(64, 2)
    src = Source(bytes(32))
    sk_g = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_g)
    data = np.random.default_rng(0).integers(
        -(2**10), 2**10, size=(2 * dp, 64), dtype=np.int64
    )
    pt = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 34, 3, jnp.asarray(data)),
        base2k=base2k, k=34,
    )
    ct = enc.glwe_encrypt_sk(
        m, pt, skp, base2k, k_ct, xe, xa, batch_shape=(2 * dp,)
    )
    ptg = np.zeros(64, dtype=np.int64)
    ptg[1] = 1
    ggsw = enc.ggsw_encrypt_sk(
        m, jnp.asarray(ptg), skp, base2k, k_key, dnum=3,
        source_xe=xe, source_xa=xa,
    )
    ggswp = ggsw_prepare(m, ggsw)
    mesh2 = jax.make_mesh((dp, tp), ("dp", "tp"))
    fn = sharded_external_product_fn(
        m, mesh2, base2k, glwe_size(base2k, k_ct), ggswp.base2k
    )
    out2 = fn(shard_batch(mesh2, ct.data), ggswp.pmat)
    jax.block_until_ready(out2)
    print(f"tp: external product on (dp={dp}, tp={tp}) mesh ✓ "
          f"(hybrid mesh axes: {dict(zip(mesh.axis_names, mesh.devices.shape))})")

    # --- (dp, sp): ring-degree-sharded external product -------------------
    from poulpy_tpu.parallel.sharded import sharded_external_product_ring_fn

    sp = min(4, ndev)
    dp3 = ndev // sp
    mesh3 = jax.make_mesh((dp3, sp), ("dp", "sp"))
    m3 = get_module(max(64, 16 * sp), 2)
    n3 = m3.n
    data3 = np.random.default_rng(1).integers(
        -(2**10), 2**10, size=(dp3, n3), dtype=np.int64
    )
    pt3 = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 34, 3, jnp.asarray(data3)),
        base2k=base2k, k=34,
    )
    ct3 = enc.glwe_encrypt_sk(
        m3, pt3, glwe_secret_prepare(m3, enc.secret_new(m3, 1, src)),
        base2k, k_ct, xe, xa, batch_shape=(dp3,),
    )
    ggsw3 = enc.ggsw_encrypt_sk(
        m3, jnp.asarray(np.eye(1, n3, 1, dtype=np.int64)[0]), skp,
        base2k, k_key, dnum=3, source_xe=xe, source_xa=xa,
    )
    ggswp3 = ggsw_prepare(m3, ggsw3)
    rfn = sharded_external_product_ring_fn(
        m3, mesh3, base2k, glwe_size(base2k, k_ct), ggswp3.base2k
    )
    out3 = rfn(
        jax.device_put(ct3.data, NamedSharding(mesh3, P("dp", None, None, "sp"))),
        jax.device_put(
            ggswp3.pmat,
            NamedSharding(mesh3, P(None, None, None, None, None, "sp")),
        ),
    )
    jax.block_until_ready(out3)
    print(f"sp: ring-sharded external product (N={n3} over sp={sp}) ✓")

    # --- mesh-attached Module: the PUBLIC API runs dp-sharded with NO
    # wrapper functions (hal.module.module_with_mesh + parallel/auto.py)
    from poulpy_tpu.core.external_product import glwe_external_product
    from poulpy_tpu.hal.module import module_with_mesh
    from poulpy_tpu.parallel.auto import shard_batch as auto_shard

    mm = module_with_mesh(m, mesh_dp)
    ct_sh = ct.replace(data=auto_shard(mm, ct.data))
    want = glwe_external_product(m, ct, ggswp)        # local
    have = glwe_external_product(mm, ct_sh, ggswp)    # same call, sharded
    assert np.array_equal(np.asarray(have.data), np.asarray(want.data))
    print(f"mesh-module: public external product dp-sharded over "
          f"{ndev} devices, bit-exact vs local ✓ "
          f"({have.data.sharding.spec})")


if __name__ == "__main__":
    enable_compile_cache()
    main()
