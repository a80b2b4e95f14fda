"""Sharded execution of the hot primitives over a (dp, tp) mesh.

dp: ciphertext-batch data parallelism (embarrassingly parallel — the batch
axis is the throughput axis).
tp: CRT-prime tensor parallelism — every device owns P/tp primes and runs
DFT → VMP → inverse-DFT for them end-to-end; one `all_gather` per inverse
transform assembles the residues for the centered Garner lift.
This mirrors the SURVEY §7 plan ("limb/batch axes sharded over the mesh,
partial sums via collectives") with the collective placed where the CRT
structure makes it cheapest.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.normalization import vec_znx_normalize_full
from poulpy_tpu.hal.ntt import garner_lift, ntt_inverse


def shard_batch(mesh, x, axis: int = 0):
    """Place an array with its leading batch axis sharded over dp."""
    spec = [None] * x.ndim
    spec[axis] = "dp"
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def _local_tables(module: Module, psi, psi_inv, n_inv, p, qinv, r2, two40):
    t = SimpleNamespace(
        n=module.n,
        logn=module.log_n,
        psi_brv=psi,
        psi_inv_brv=psi_inv,
        n_inv=n_inv,
        p=p,
        qinv=qinv,
        r2=r2,
        two40_mod_p=two40,
    )
    return SimpleNamespace(tables=t, n=module.n, nprimes=p.shape[0])


def sharded_external_product_fn(
    module: Module,
    mesh,
    res_base2k: int,
    res_size: int,
    ggsw_base2k: int,
):
    """Build a jitted (dp, tp)-sharded batched external product.

    Returns fn(ct_data [B, rank+1, size, N], pmat [rows, ci, co, psize, P, N])
    → [B, rank+1, res_size, N].  The pmat and twiddle tables are sharded on
    their prime axis over tp; ct batches shard over dp.
    """
    t = module.tables

    def local_step(ct, pmat, psi, psi_inv, n_inv, p, qinv, r2, two40):
        lm = _local_tables(module, psi, psi_inv, n_inv, p, qinv, r2, two40)
        a_dft = dft.dft_apply(lm, ct)                    # local primes
        res_dft = dft.vmp_apply(lm, a_dft, pmat)
        res_coeff = ntt_inverse(lm.tables, res_dft)      # still local primes
        full = jax.lax.all_gather(res_coeff, "tp", axis=-2, tiled=True)
        big = garner_lift(t, full)                       # replicated constants
        return vec_znx_normalize_full(
            res_size, res_base2k, 0, big, ggsw_base2k
        )

    shard = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("dp"),                                     # ct batch
            P(None, None, None, None, "tp", None),       # pmat prime axis
            P("tp", None),                               # psi
            P("tp", None),                               # psi_inv
            P("tp"),                                     # n_inv
            P("tp"),                                     # p
            P("tp"),                                     # qinv
            P("tp"),                                     # r2
            P("tp"),                                     # two40
        ),
        out_specs=P("dp"),
        check_vma=False,
    )

    def fn(ct_data, pmat):
        return shard(
            ct_data, pmat, t.psi_brv, t.psi_inv_brv, t.n_inv,
            t.p, t.qinv, t.r2, t.two40_mod_p,
        )

    return jax.jit(fn)


def sharded_gate_bootstrap_fn(keys, mesh, gate: str = "nand"):
    """dp-sharded batched gate bootstrapping — the scale-out axis.

    Gate bootstrapping is embarrassingly parallel over the ciphertext batch
    (each bootstrap touches only its own LWE), so the mapping is pure data
    parallelism: the batch axis of both LWE inputs shards over
    `dp`, every key tensor (BRK pmats, switching key, LUT, x-power table)
    replicates, and XLA's SPMD partitioner splits the whole blind-rotation
    scan per device with zero collectives.  Aggregate throughput is
    bootstraps/s/device × n_devices (the reference has no distributed
    layer, SURVEY.md §2.8).

    `keys`: binfhe.gates.BootstrapKeys.  Returns
    fn(c1_data [B, size, n_lwe+1], c2_data like) → [B, size, n_lwe+1], with
    B divisible by the mesh's dp extent; bit-exact vs the single-device gate.
    """
    from poulpy_tpu.binfhe import gates
    from poulpy_tpu.core.layouts import LWECiphertext

    gate_fn = {
        "nand": gates.gate_nand,
        "and": gates.gate_and,
        "or": gates.gate_or,
        "nor": gates.gate_nor,
        "xor": gates.gate_xor,
        "xnor": gates.gate_xnor,
    }[gate]
    params = keys.params
    dp = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    # key tensors enter as replicated jit ARGUMENTS: captured by closure they
    # would be embedded in the program as constants (the BRK alone is
    # hundreds of MB at production sizes)
    key_arrays = jax.device_put((keys.brk, keys.to_lwe, keys.lut), rep)

    def fn(key_arrays, c1_data, c2_data):
        brk, to_lwe, lut = key_arrays
        k = dataclasses.replace(keys, brk=brk, to_lwe=to_lwe, lut=lut)
        c1 = LWECiphertext(data=c1_data, base2k=params.base2k, k=params.k_ct)
        c2 = c1.replace(data=c2_data)
        return gate_fn(k, c1, c2).data

    jitted = jax.jit(fn, in_shardings=(rep, dp, dp), out_shardings=dp)
    return lambda c1_data, c2_data: jitted(key_arrays, c1_data, c2_data)


def sharded_external_product_ring_fn(
    module: Module,
    mesh,
    res_base2k: int,
    res_size: int,
    ggsw_base2k: int,
    axis: str = "sp",
):
    """(dp, sp)-sharded external product with the **ring degree N split over
    `sp`** — one transform across devices (parallel/sharded_ntt.py
    butterfly all_to_alls), for N beyond one device's memory (SURVEY §2.8
    design point).

    Everything except the NTT stage exchanges is lane-local: residue entry,
    the VMP contraction (pointwise per lane), the Garner lift and the
    carry-normalization all act per coefficient.  Returns
    fn(ct [B, rank+1, size, N], pmat [rows, ci, co, psize, P, N]) →
    [B, rank+1, res_size, N], bit-exact vs the single-device path.
    """
    from poulpy_tpu.hal.ntt import to_residues
    from poulpy_tpu.parallel.sharded_ntt import (
        sharded_ntt_forward,
        sharded_ntt_inverse,
    )

    t = module.tables
    primes = module.basis.primes
    n = module.n
    d = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]

    def local_step(ct, pmat_local):
        r = to_residues(t, ct).astype(jnp.int64)      # lane-local entry
        a_dft = sharded_ntt_forward(primes, n, d, axis, r)
        res_dft = dft.vmp_apply(module, a_dft, pmat_local)   # pointwise
        res_coeff = sharded_ntt_inverse(primes, n, d, axis, res_dft)
        big = garner_lift(t, res_coeff)               # lane-local exit
        return vec_znx_normalize_full(res_size, res_base2k, 0, big, ggsw_base2k)

    shard = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("dp", None, None, axis),
            P(None, None, None, None, None, axis),
        ),
        out_specs=P("dp", None, None, axis),
        check_vma=False,
    )
    return jax.jit(shard)


def sharded_blind_rotation_block_fn(
    module: Module,
    mesh,
    lut,                      # binfhe.lut.LookupTable (ext == 1)
    brk,                      # binfhe.blind_rotation.BlindRotationKeyPrepared
    block_size: int,
    axis: str = "kp",
):
    """Block-binary CGGI blind rotation with the **blind-rotation key
    sharded over `axis`** — the first capability a single device cannot
    replicate when the BRK exceeds its memory.

    The BRK is the big tensor of the scheme (n_lwe × dnum × (rank+1)² ×
    psize × P × N int32 — e.g. ~0.9 GB at N=2048/n_lwe=568/dnum=3 and
    several GB at N=4096): each device stores only block members
    i ≡ device (mod kp).  Within one block step the members' contributions
    are independent given the accumulator
    (algorithm.rs:275-368: acc += Σ_i (X^{a_i}−1)·(BRK_i ⊡ acc)), so a
    step is a LOCAL VMP + x-power rotate per device, one `psum` of the
    NTT-domain update over kp (sum-then-reduce is exact: D·p < 2^63, and
    mod-p is a ring hom, so the canonical residues match the sequential
    dft_add chain bit-for-bit), then the replicated accumulator update.
    The ciphertext batch shards over `dp` as usual.

    Returns fn(lwe: LWECiphertext[B, ...]) → acc data [B, rank+1, size, N],
    bit-exact vs blind_rotation_execute_block.
    """
    from poulpy_tpu.binfhe.blind_rotation import _xpow_table, mod_switch_2n
    from poulpy_tpu.hal.ntt import mont_mul

    assert lut.extension_factor == 1
    t = module.tables
    n = module.n
    base2k = brk.base2k
    size = lut.size
    rank = brk.rank
    n_lwe = brk.n_lwe
    d = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    assert n_lwe % block_size == 0 and block_size % d == 0, (
        n_lwe, block_size, d)
    nblocks = n_lwe // block_size
    bs_local = block_size // d
    xpow = jnp.asarray(_xpow_table(n, module.basis.primes))
    p_bc = t.p[:, None]
    qinv_bc = t.qinv[:, None]

    def local_step(b, a_blk, pm_blk, lut_data):
        # b [Bl]; a_blk [nblocks, bs_local, Bl];
        # pm_blk [nblocks, bs_local, rows, ci, co, psize, P, N]
        from poulpy_tpu.hal.vec_znx import vec_znx_rotate

        batch = b.shape
        body = vec_znx_rotate(b[..., None], lut_data[0])
        acc0 = jnp.concatenate(
            [body[..., None, :, :],
             jnp.zeros(batch + (rank, size, n), jnp.int64)], axis=-3
        )

        def block_step(acc, inputs):
            a_i, pm_i = inputs
            acc_dft = dft.dft_apply(module, acc)
            add_dft = None
            for i in range(bs_local):
                vmp_res = dft.vmp_apply(module, acc_dft, pm_i[i])
                apos = a_i[i] & (2 * n - 1)
                xp = jnp.take(xpow, apos, axis=0)         # [Bl, P, N]
                rot = mont_mul(
                    vmp_res, xp[..., None, None, :, :], p_bc, qinv_bc
                )
                term = dft.dft_sub(module, rot, vmp_res)
                add_dft = (term if add_dft is None
                           else dft.dft_add(module, add_dft, term))
            # plain sum over kp widened to i64 (DFT residues are i32 and
            # d·p overflows i32), one exact mod-p afterwards == the
            # sequential dft_add chain (mod-p is a ring hom)
            add_dft = (
                jax.lax.psum(add_dft.astype(jnp.int64), axis) % p_bc
            ).astype(jnp.int32)
            big = dft.idft_apply(module, add_dft)
            big = big + dft._align_limbs(
                acc, big, big.shape[-2], limb_axis=-2
            )[0]
            return dft.big_normalize(module, size, base2k, big, base2k), None

        acc, _ = jax.lax.scan(block_step, acc0, (a_blk, pm_blk))
        return acc

    shard = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("dp"),                 # mod-switched bodies (batch)
            P(None, axis, "dp"),     # rotation amounts: block members / kp
            P(None, axis),           # BRK: block members sharded over kp
            P(),                     # LUT replicated
        ),
        out_specs=P("dp"),
        check_vma=False,
    )

    # the BRK is placed once, each device holding only its block members,
    # and enters the program as an argument (not an embedded constant)
    pm_blk = jax.device_put(
        brk.pmats.reshape((nblocks, block_size) + brk.pmats.shape[1:]),
        NamedSharding(mesh, P(None, axis)),
    )
    lut_data = jax.device_put(lut.data, NamedSharding(mesh, P()))

    def fn(pm_blk, lut_data, lwe):
        lwe_2n = mod_switch_2n(2 * n, lwe, lut.rot_dir)
        b = lwe_2n[..., 0]
        a = lwe_2n[..., 1:]
        a_blk = jnp.moveaxis(a, -1, 0).reshape(
            (nblocks, block_size) + b.shape
        )
        return shard(b, a_blk, pm_blk, lut_data)

    jitted = jax.jit(fn)
    dp = NamedSharding(mesh, P("dp"))
    return lambda lwe: jitted(pm_blk, lut_data, jax.device_put(lwe, dp))
