"""CGGI blind rotation
(poulpy-bin-fhe/src/blind_rotation/algorithms/cggi/algorithm.rs).

Standard path (algorithm.rs:370-443):
    acc ← X^b · LUT
    for each LWE coeff a_i:  acc += (X^{a_i} − 1)·(BRK_i ⊡ acc)
    normalize once at the end.

Batched realization: the loop is a `lax.scan` over the stacked prepared
GGSW key tensor; rotation amounts are traced per batch element, so one
compiled scan evaluates an entire batch of blind rotations (the
gate-bootstraps/s axis).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from poulpy_tpu.core.encryption import ggsw_encrypt_sk
from poulpy_tpu.core.layouts import LWECiphertext, glwe_size
from poulpy_tpu.core.prepared import GLWESecretPrepared
from poulpy_tpu.binfhe.lut import LookupTable
from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.ntt import mont_mul
from poulpy_tpu.hal.normalization import vec_znx_normalize
from poulpy_tpu.hal.vec_znx import vec_znx_rotate
from poulpy_tpu.utils import struct


def _static(**kw):
    return struct.field(pytree_node=False, **kw)


@struct.dataclass
class BlindRotationKeyPrepared:
    """One prepared GGSW per LWE secret coefficient, stacked:
    pmats [n_lwe, dnum, rank+1, rank+1, size, P, N]
    (blind_rotation/layouts/key.rs:149-153 + prepared form)."""

    pmats: jnp.ndarray
    base2k: int = _static()
    k: int = _static()
    dsize: int = _static(default=1)
    dist: str = _static(default="binary_prob")

    @property
    def n_lwe(self) -> int:
        return self.pmats.shape[0]

    @property
    def rank(self) -> int:
        return self.pmats.shape[-4] - 1


@struct.dataclass
class BlindRotationKeyCompressed:
    """Seeded BRK: one GGSWCompressed stacked over the n_lwe coefficients
    (blind_rotation/layouts/key_compressed.rs + encryption/key_compressed.rs);
    (rank+1)× smaller for transport, decompress + prepare on the device."""

    ggsw: object  # core.compressed.GGSWCompressed with batch (n_lwe,)
    dist: str = _static(default="binary_prob")


def blind_rotation_key_encrypt_sk_compressed(
    module: Module,
    sk_lwe,
    sk_glwe: GLWESecretPrepared,
    base2k: int,
    k: int,
    dnum: int,
    source_xe,
    source_xa,
    dsize: int = 1,
    **kw,
) -> BlindRotationKeyCompressed:
    from poulpy_tpu.core.compressed import ggsw_encrypt_sk_compressed

    n_lwe = sk_lwe.shape[-1]
    pt = jnp.zeros((n_lwe, module.n), jnp.int64).at[:, 0].set(
        jnp.asarray(sk_lwe)
    )
    ggsw = ggsw_encrypt_sk_compressed(
        module, pt, sk_glwe, base2k, k, dnum, source_xe, source_xa,
        dsize=dsize, **kw,
    )
    return BlindRotationKeyCompressed(ggsw=ggsw)


def blind_rotation_key_decompress(
    module: Module, key: BlindRotationKeyCompressed
) -> BlindRotationKeyPrepared:
    """Regenerate the mask columns and move to the prepared (NTT) domain."""
    from poulpy_tpu.core.compressed import ggsw_decompress

    ggsw = ggsw_decompress(module, key.ggsw)
    pmats = dft.vmp_prepare(module, ggsw.data)
    return BlindRotationKeyPrepared(
        pmats=pmats, base2k=ggsw.base2k, k=ggsw.k, dsize=ggsw.dsize,
        dist=key.dist,
    )


def blind_rotation_key_encrypt_sk(
    module: Module,
    sk_lwe,                  # [n_lwe] binary secret
    sk_glwe: GLWESecretPrepared,
    base2k: int,
    k: int,
    dnum: int,
    source_xe,
    source_xa,
    dsize: int = 1,
    **kw,
) -> BlindRotationKeyPrepared:
    """BRK: GGSW(s_lwe[i]) for every i, batched through one keygen call
    (blind_rotation/encryption/)."""
    n_lwe = sk_lwe.shape[-1]
    pt = jnp.zeros((n_lwe, module.n), jnp.int64).at[:, 0].set(
        jnp.asarray(sk_lwe)
    )
    ggsw = ggsw_encrypt_sk(
        module, pt, sk_glwe, base2k, k, dnum, source_xe, source_xa,
        dsize=dsize, **kw,
    )
    pmats = dft.vmp_prepare(module, ggsw.data)
    return BlindRotationKeyPrepared(
        pmats=pmats, base2k=base2k, k=k, dsize=dsize
    )


def mod_switch_2n(two_n: int, lwe: LWECiphertext, rot_dir: str = "left"):
    """Round an LWE to Z_{2N} indices (algorithms/mod.rs:136-171).

    Returns int64 `[..., n_lwe+1]` with (b, a_1..a_n) in [-N, N].
    """
    base2k = lwe.base2k
    log2n = two_n.bit_length()  # == log2(two_n) + 1 for power of two
    x = lwe.data[..., 0, :]
    if rot_dir == "left":
        x = -x
    if base2k > log2n:
        diff = base2k - (log2n - 1)
        return (x + (1 << (diff - 1))) >> diff
    size = -(-log2n // base2k)
    rem = base2k - (log2n % base2k)
    data = lwe.data if rot_dir != "left" else -lwe.data
    y = data[..., 0, :]
    for i in range(1, size):
        if i == size - 1 and rem != base2k:
            k_rem = base2k - rem
            y = (y << k_rem) + (data[..., i, :] >> rem)
        else:
            y = (y << base2k) + data[..., i, :]
    return y


@functools.partial(jax.jit, static_argnames=("module", "res_k"))
def blind_rotation_execute(
    module: Module,
    lwe: LWECiphertext,
    lut: LookupTable,
    brk: BlindRotationKeyPrepared,
    res_k: int | None = None,
):
    """Standard CGGI path (algorithm.rs:370-443) as a scanned batch op.

    Returns GLWE data `[..., rank+1, size, N]` (base2k = brk.base2k)
    encrypting X^{-dec(lwe)}·LUT.  Only extension_factor == 1 supported here
    (the block-binary / extended paths are separate follow-ups).
    """
    if module.mesh is not None:
        from poulpy_tpu.parallel.auto import dp_shard

        return dp_shard(
            module,
            lambda l: blind_rotation_execute(module.local, l, lut, brk,
                                             res_k),
            lwe,
        )
    assert lut.extension_factor == 1
    n = module.n
    base2k = brk.base2k
    res_k = lut.size * base2k if res_k is None else res_k
    size = lut.size
    rank = brk.rank

    lwe_2n = mod_switch_2n(2 * n, lwe, lut.rot_dir)
    b = lwe_2n[..., 0]
    a = lwe_2n[..., 1:]
    batch = b.shape

    # acc: [..., rank+1, size, N]; body = X^b · LUT, mask = 0
    # (p broadcasts per batch element over the limb axis, hence [..., None])
    body = vec_znx_rotate(b[..., None] if batch else b, lut.data[0])
    if batch:
        body_col = body[..., None, :, :]
        mask = jnp.zeros(batch + (rank, size, n), jnp.int64)
        acc0 = jnp.concatenate([body_col, mask], axis=-3)
    else:
        acc0 = jnp.concatenate(
            [body[None], jnp.zeros((rank, size, n), jnp.int64)], axis=0
        )

    def step(acc, inputs):
        a_i, pmat_i = inputs
        a_dft = dft.dft_apply(module, acc)
        res_dft = dft.vmp_apply(module, a_dft, pmat_i)
        big = dft.idft_apply(module, res_dft)
        tmp = dft.big_normalize(module, size, base2k, big, base2k)
        p = a_i[..., None, None] if batch else a_i
        upd = vec_znx_rotate(p, tmp) - tmp
        return acc + upd, None

    a_scan = jnp.moveaxis(a, -1, 0)                    # [n_lwe, ...batch]
    acc, _ = jax.lax.scan(step, acc0, (a_scan, brk.pmats))
    return vec_znx_normalize(base2k, acc)


def blind_rotation_dispatch(
    module: Module,
    lwe: LWECiphertext,
    lut: LookupTable,
    brk: BlindRotationKeyPrepared,
    block_size: int = 1,
    res_k: int | None = None,
):
    """Path selection (BlindRotationExecute::execute, algorithm.rs:88-118):
    the extended multi-poly path when the LUT spans extension_factor > 1
    polynomials, the block-binary path for block_size > 1 keys, else the
    standard one-external-product-per-coefficient path."""
    if lut.extension_factor > 1:
        return blind_rotation_execute_extended(
            module, lwe, lut, brk, block_size, res_k=res_k
        )
    if block_size > 1:
        return blind_rotation_execute_block(
            module, lwe, lut, brk, block_size, res_k=res_k
        )
    return blind_rotation_execute(module, lwe, lut, brk, res_k=res_k)


def _ntt_of_x(p: int, n: int) -> np.ndarray:
    """hal.ntt.ntt_forward of the monomial X for one prime, replicated
    host-side in numpy (same psi table, same stage schedule), `[N]` in
    standard form."""
    from poulpy_tpu.hal.ntt import _host_tables
    from poulpy_tpu.hal.primes import R

    psi_t, _, _ = _host_tables((p,), n)
    w_all = psi_t[0] * pow(R, -1, p) % p        # tables are Montgomery form
    x = np.zeros(n, dtype=np.int64)
    x[1] = 1
    for s in range(n.bit_length() - 1):
        m = 1 << s
        xr = x.reshape(m, 2, n >> (s + 1))
        lo, hi = xr[:, 0, :], xr[:, 1, :]
        v = hi * w_all[m : 2 * m, None] % p
        x = np.stack([(lo + v) % p, (lo - v) % p], axis=1).reshape(n)
    return x


@functools.lru_cache(maxsize=None)
def _xpow_table(n: int, primes: tuple):
    """Montgomery NTT of X^j for every j in [0, 2N): `[2N, P, N]` int64
    NUMPY array (the x_pow_a cache of the block-binary path,
    blind_rotation/layouts/key.rs + utils.rs:6).

    Computed entirely host-side: the NTT is an evaluation-domain transform,
    so NTT(X^j) = NTT(X)^{⊙j} (pointwise powers of `_ntt_of_x`), and
    X^{N+j} = −X^j (negacyclic wrap).  Host numpy keeps this lru cache
    trace-safe: it is usually first populated while TRACING a jitted caller,
    and a cached jnp value built there would be a leaked tracer, crashing the
    next differently-shaped trace with UnexpectedTracerError (regression test
    test_xpow_table_cache_no_tracer_leak)."""
    from poulpy_tpu.hal.primes import R

    P = len(primes)
    out = np.zeros((2 * n, P, n), dtype=np.int64)
    for pi, p in enumerate(primes):
        base = _ntt_of_x(p, n)                  # canonical NTT(X), [N]
        row = np.full(n, R % p, dtype=np.int64)  # Montgomery(X^0)
        for j in range(n):
            out[j, pi] = row
            row = row * base % p                # < 2^60: exact in int64
        out[n:, pi] = (p - out[:n, pi]) % p     # X^{N+j} = −X^j
    return out


@functools.partial(
    jax.jit, static_argnames=("module", "block_size", "res_k")
)
def blind_rotation_execute_block(
    module: Module,
    lwe: LWECiphertext,
    lut: LookupTable,
    brk: BlindRotationKeyPrepared,
    block_size: int,
    res_k: int | None = None,
):
    """Block-binary CGGI path (execute_block_binary, algorithm.rs:275-368).

    For block-binary LWE secrets (≤ one set coefficient per block) the
    accumulator's forward DFT and the closing iDFT+normalize amortize over a
    whole block; within the block each coefficient contributes
    (X^{a_i} − 1)·(DFT(acc) ⊡ BRK_i) accumulated in the NTT domain, with
    X^{a_i} applied as a gather from the precomputed x-power table.
    """
    if module.mesh is not None:
        from poulpy_tpu.parallel.auto import dp_shard

        return dp_shard(
            module,
            lambda l: blind_rotation_execute_block(
                module.local, l, lut, brk, block_size, res_k
            ),
            lwe,
        )
    assert lut.extension_factor == 1
    n = module.n
    base2k = brk.base2k
    size = lut.size
    rank = brk.rank
    n_lwe = brk.n_lwe
    assert n_lwe % block_size == 0
    nblocks = n_lwe // block_size

    lwe_2n = mod_switch_2n(2 * n, lwe, lut.rot_dir)
    b = lwe_2n[..., 0]
    a = lwe_2n[..., 1:]
    batch = b.shape

    body = vec_znx_rotate(b[..., None] if batch else b, lut.data[0])
    if batch:
        acc0 = jnp.concatenate(
            [body[..., None, :, :],
             jnp.zeros(batch + (rank, size, n), jnp.int64)], axis=-3
        )
    else:
        acc0 = jnp.concatenate(
            [body[None], jnp.zeros((rank, size, n), jnp.int64)], axis=0
        )

    xpow = _xpow_table(n, module.basis.primes)
    t = module.tables

    a_blocks = jnp.moveaxis(a, -1, 0).reshape((nblocks, block_size) + batch)
    pm_blocks = brk.pmats.reshape((nblocks, block_size) + brk.pmats.shape[1:])

    def block_step(acc, inputs):
        a_blk, pm_blk = inputs
        acc_dft = dft.dft_apply(module, acc)
        add_dft = None
        for i in range(block_size):
            vmp_res = dft.vmp_apply(module, acc_dft, pm_blk[i])
            apos = a_blk[i] & (2 * n - 1)
            xp = jnp.take(xpow, apos, axis=0)       # [..., P, N]
            rot = mont_mul(
                vmp_res,
                xp[..., None, None, :, :] if batch else xp[None, None],
                t.p[:, None], t.qinv[:, None],
            )
            term = dft.dft_sub(module, rot, vmp_res)
            add_dft = term if add_dft is None else dft.dft_add(module, add_dft, term)
        big = dft.idft_apply(module, add_dft)
        big = big + dft._align_limbs(acc, big, big.shape[-2], limb_axis=-2)[0]
        acc = dft.big_normalize(module, size, base2k, big, base2k)
        return acc, None

    acc, _ = jax.lax.scan(block_step, acc0, (a_blocks, pm_blocks))
    return acc


@functools.partial(
    jax.jit, static_argnames=("module", "block_size", "res_k")
)
def blind_rotation_execute_extended(
    module: Module,
    lwe: LWECiphertext,
    lut: LookupTable,
    brk: BlindRotationKeyPrepared,
    block_size: int = 1,
    res_k: int | None = None,
):
    """Extended block-binary CGGI (execute_block_binary_extended,
    algorithm.rs:121-273): the LUT spans `extension_factor` degree-N
    polynomials (effective domain N·ext), held as a stacked accumulator axis.

    A uniform rule replacing the reference's data-dependent
    branches: for a rotation amount with hi/lo split (q = hi·ext + lo in
    Z_{2N·ext}), output part i sources part (i − lo) mod ext multiplied by
    X^{hi + (i < lo)} — realized as a batched gather over the part axis plus
    an x-power-table gather, identical for every a_i.
    """
    if module.mesh is not None:
        from poulpy_tpu.parallel.auto import dp_shard

        return dp_shard(
            module,
            lambda l: blind_rotation_execute_extended(
                module.local, l, lut, brk, block_size, res_k
            ),
            lwe,
        )
    ext = lut.extension_factor
    n = module.n
    base2k = brk.base2k
    size = lut.size
    rank = brk.rank
    n_lwe = brk.n_lwe
    assert n_lwe % block_size == 0
    nblocks = n_lwe // block_size
    two_n_ext = 2 * n * ext

    lwe_2n = mod_switch_2n(two_n_ext, lwe, lut.rot_dir)
    b_pos = lwe_2n[..., 0] & (two_n_ext - 1)
    a = lwe_2n[..., 1:] & (two_n_ext - 1)
    batch = b_pos.shape

    idx_i = jnp.arange(ext)

    def part_mix(parts, pos, rotate_fn):
        """parts [..., ext, ...], pos [...] in [0, 2N·ext): output part i =
        rotate(hi + (i < lo))(parts[(i − lo) mod ext])."""
        hi = pos // ext
        lo = pos % ext
        src = (idx_i - lo[..., None]) % ext          # [..., ext]
        gathered = jnp.take_along_axis(
            parts,
            src.reshape(src.shape + (1,) * (parts.ndim - src.ndim)),
            axis=len(batch),
        )
        expo = hi[..., None] + (idx_i < lo[..., None])
        return rotate_fn(gathered, expo)

    # --- init: acc[i] = X^{b_hi + (i<b_lo)} · lut[(i − b_lo) mod ext] ------
    lut_parts = jnp.broadcast_to(lut.data, batch + (ext, size, n))

    def rot_coeff(g, expo):
        # expo [..., ext] broadcasts over the limb axis of g [..., ext, size, N]
        return vec_znx_rotate(expo[..., None], g)

    body = part_mix(lut_parts, b_pos, rot_coeff)      # [..., ext, size, N]
    acc = jnp.concatenate(
        [body[..., :, None, :, :],
         jnp.zeros(batch + (ext, rank, size, n), jnp.int64)],
        axis=-3,
    )                                                  # [..., ext, cols, size, N]

    xpow = _xpow_table(n, module.basis.primes)
    t = module.tables
    a_blocks = jnp.moveaxis(a, -1, 0).reshape((nblocks, block_size) + batch)
    pm_blocks = brk.pmats.reshape((nblocks, block_size) + brk.pmats.shape[1:])

    def rot_dft(g, expo):
        """NTT-domain rotation: pointwise × NTT(X^{expo mod 2N})."""
        xp = jnp.take(xpow, expo & (2 * n - 1), axis=0)   # [..., ext, P, N]
        return mont_mul(
            g, xp[..., :, None, None, :, :], t.p[:, None], t.qinv[:, None]
        )

    def block_step(acc, inputs):
        a_blk, pm_blk = inputs
        acc_dft = dft.dft_apply(module, acc)   # [..., ext, cols, size, P, N]
        add_dft = None
        for i in range(block_size):
            vmp_res = dft.vmp_apply(module, acc_dft, pm_blk[i])
            term = dft.dft_sub(
                module, part_mix(vmp_res, a_blk[i], rot_dft), vmp_res
            )
            add_dft = term if add_dft is None else dft.dft_add(module, add_dft, term)
        big = dft.idft_apply(module, add_dft)
        big = big + dft._align_limbs(acc, big, big.shape[-2], limb_axis=-2)[0]
        return dft.big_normalize(module, size, base2k, big, base2k), None

    acc, _ = jax.lax.scan(block_step, acc, (a_blocks, pm_blocks))
    return acc[..., 0, :, :, :]
