"""HAL-equivalent kernel layer: limb tensors, modular NTT basis, znx kernels.

The reference's hardware abstraction layer (poulpy-hal) exposes ~120
per-operation traits over opaque backends.  The equivalent here is a flat
functional surface over `jax.numpy` arrays:

  * polynomials ("znx") are arrays whose last axis is the ring degree N,
  * limb vectors ("vec_znx", reference poulpy-hal/src/layouts/vec_znx.rs:35)
    are int64 arrays `[..., size, N]` (limb-major like the reference),
  * DFT-domain vectors ("vec_znx_dft") are int64 CRT-residue arrays
    `[..., size, nprimes, N]` produced by an exact negacyclic NTT,
  * big-coefficient accumulators ("vec_znx_big") are int64 `[..., size, N]`
    with wrapping-i64 semantics (the FFT64-family convention,
    poulpy-cpu-ref/src/fft64/module.rs:40-44),
  * prepared operands (svp/vmp) are Montgomery-domain residue arrays.

Everything is shape-polymorphic in the leading axes, so batching is plain
broadcasting / `jax.vmap` — the throughput axis.
"""
