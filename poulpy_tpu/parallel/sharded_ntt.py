"""Ring-degree-sharded negacyclic NTT with all-to-all stage exchange.

The SURVEY §2.8 design point: for N too large for one device (or to split
one transform across several), the N axis shards over a mesh axis ("sp")
and butterfly stages exchange data all-to-all (over NVLink between the GPUs
of one host).

Key observation: Cooley–Tukey stage with half-length h pairs lanes (j, j+h).
  * In *cyclic* distribution (device d holds j ≡ d mod D) every stage with
    D | h is local.
  * In *block* distribution (device d holds j ∈ [d·M, (d+1)·M), M = N/D)
    every stage with 2h | M is local.
Since D ≤ M/2 for D² ≤ N/2, the forward transform runs stages
h = N/2 … D cyclically, performs ONE all_to_all to block layout, and
finishes h = D/2 … 1 locally; the inverse (Gentleman–Sande) mirrors this.
Entry/exit all_to_alls convert between the natural (block) coefficient
layout and the cyclic layout, so a forward+inverse round trip costs four
all_to_alls total — each moving N/D elements per device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from poulpy_tpu.hal.ntt import add_mod, mont_mul, sub_mod
from poulpy_tpu.hal.primes import R


@functools.lru_cache(maxsize=None)
def _stage_vectors(primes: tuple, n: int, inverse: bool):
    """Full-length per-stage twiddle vectors [S, P, N] (natural j order)."""
    from poulpy_tpu.hal.ntt import _host_tables

    psi_t, psi_inv_t, n_inv = _host_tables(primes, n)
    logn = n.bit_length() - 1
    P = len(primes)
    out = np.zeros((logn, P, n), dtype=np.int64)
    src = psi_inv_t if inverse else psi_t
    for s in range(logn):
        m = 1 << s
        two_half = n >> s
        idx = m + np.arange(n) // two_half
        stage = s if not inverse else (logn - 1 - s)
        out[stage] = src[:, idx]
    return out, n_inv


def _butterfly_fwd(x, w, p, qinv, h_local):
    """CT butterflies at local half-length h_local on [..., L] lanes."""
    lead = x.shape[:-1]
    L = x.shape[-1]
    xr = x.reshape(lead + (L // (2 * h_local), 2, h_local))
    lo = xr[..., 0, :]
    hi = xr[..., 1, :]
    wr = w.reshape(w.shape[:-1] + (L // (2 * h_local), 2, h_local))[..., 1, :]
    v = mont_mul(hi, wr, p[..., None], qinv[..., None])
    return jnp.stack(
        [add_mod(lo, v, p[..., None]), sub_mod(lo, v, p[..., None])], axis=-2
    ).reshape(x.shape)


def _butterfly_inv(x, w, p, qinv, h_local):
    lead = x.shape[:-1]
    L = x.shape[-1]
    xr = x.reshape(lead + (L // (2 * h_local), 2, h_local))
    lo = xr[..., 0, :]
    hi = xr[..., 1, :]
    wr = w.reshape(w.shape[:-1] + (L // (2 * h_local), 2, h_local))[..., 1, :]
    u = add_mod(lo, hi, p[..., None])
    v = mont_mul(sub_mod(lo, hi, p[..., None]), wr, p[..., None], qinv[..., None])
    return jnp.stack([u, v], axis=-2).reshape(x.shape)


def _block_to_cyclic(x_local, axis_name: str, d: int):
    """Natural block shards → cyclic shards (one all_to_all + local shuffle).

    Local block [.., M] of device dd holds j = dd·M + m.  Cyclic wants
    j ≡ dd (mod D) i.e. j = m'·D + dd.  Chunk m-locals by destination
    (j mod D), all_to_all, then interleave received chunks.
    """
    lead = x_local.shape[:-1]
    M = x_local.shape[-1]
    # chunk by j mod D: element m has j ≡ (dd·M + m) ≡ m (mod D) for D | M
    xr = x_local.reshape(lead + (M // d, d))
    xr = jnp.moveaxis(xr, -1, 0)            # [D_dest, ..., M/D]
    recv = jax.lax.all_to_all(xr, axis_name, 0, 0, tiled=False)
    # recv[src] = slots m' with j = m'·D + dd where m' ∈ src-block range
    return jnp.moveaxis(recv, 0, -2).reshape(lead + (M,))


def _cyclic_to_block(x_local, axis_name: str, d: int):
    """Inverse of _block_to_cyclic."""
    lead = x_local.shape[:-1]
    M = x_local.shape[-1]
    xr = x_local.reshape(lead + (d, M // d))   # chunk by destination block
    xr = jnp.moveaxis(xr, -2, 0)               # [D_dest, ..., M/D]
    recv = jax.lax.all_to_all(xr, axis_name, 0, 0, tiled=False)
    # interleave: local j-offset m = q·D + src
    return jnp.moveaxis(recv, 0, -1).reshape(lead + (M,))


def sharded_ntt_forward(primes: tuple, n: int, d: int, axis_name: str, x_local):
    """Inside-shard_map forward NTT: x_local [..., P, M] natural block shard
    of [..., P, N]; returns same layout in the NTT domain."""
    logn = n.bit_length() - 1
    logd = d.bit_length() - 1
    M = n // d
    tables, _ = _stage_vectors(primes, n, inverse=False)
    p_arr = jnp.asarray(np.array(primes, dtype=np.int64))[:, None]
    qinv = jnp.asarray(
        np.array([(-pow(q, -1, R)) % R for q in primes], dtype=np.int64)
    )[:, None]
    dd = jax.lax.axis_index(axis_name)

    # entry: block → cyclic
    x = _block_to_cyclic(x_local, axis_name, d)

    def w_cyclic(s):
        wt = jnp.asarray(tables[s])            # [P, N]
        # cyclic shard of the twiddle vector: lanes j = m·D + dd
        return wt.reshape(wt.shape[:-1] + (M, d))[..., dd]

    for s in range(logn - logd):               # h = N/2 … D, local stride h/D
        h = n >> (s + 1)
        x = _butterfly_fwd(x, w_cyclic(s), p_arr, qinv, h // d)

    # mid: cyclic → block for the short strides
    x = _cyclic_to_block(x, axis_name, d)

    def w_block(s):
        wt = jnp.asarray(tables[s])
        return jax.lax.dynamic_slice_in_dim(wt, dd * M, M, axis=-1)

    for s in range(logn - logd, logn):         # h = D/2 … 1, local
        h = n >> (s + 1)
        x = _butterfly_fwd(x, w_block(s), p_arr, qinv, h)
    return x


def sharded_ntt_inverse(primes: tuple, n: int, d: int, axis_name: str, x_local):
    """Inverse of `sharded_ntt_forward` (GS stages, mirrored exchanges)."""
    logn = n.bit_length() - 1
    logd = d.bit_length() - 1
    M = n // d
    tables, n_inv = _stage_vectors(primes, n, inverse=True)
    p_arr = jnp.asarray(np.array(primes, dtype=np.int64))[:, None]
    qinv = jnp.asarray(
        np.array([(-pow(q, -1, R)) % R for q in primes], dtype=np.int64)
    )[:, None]
    dd = jax.lax.axis_index(axis_name)
    x = x_local

    def w_block(si):
        wt = jnp.asarray(tables[si])
        return jax.lax.dynamic_slice_in_dim(wt, dd * M, M, axis=-1)

    # short strides first (h = 1 … D/2), block-local
    for si in range(logd):
        s = logn - 1 - si
        h = n >> (s + 1)
        x = _butterfly_inv(x, w_block(si), p_arr, qinv, h)

    x = _block_to_cyclic(x, axis_name, d)

    def w_cyclic(si):
        wt = jnp.asarray(tables[si])
        return wt.reshape(wt.shape[:-1] + (M, d))[..., dd]

    for si in range(logd, logn):               # h = D … N/2, cyclic-local
        s = logn - 1 - si
        h = n >> (s + 1)
        x = _butterfly_inv(x, w_cyclic(si), p_arr, qinv, h // d)

    x = _cyclic_to_block(x, axis_name, d)
    ninv = jnp.asarray(n_inv)[:, None]
    return mont_mul(x, ninv, p_arr, qinv)
