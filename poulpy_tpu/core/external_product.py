"""GLWE × GGSW external product (poulpy-core/src/external_product/glwe.rs).

Same shape as key switching but all rank+1 columns pass through the GGSW
matrix and no small term is added back (stack §3.2).  dsize > 1 uses the
(step, offset) DFT subsampling with per-digit limb_offset accumulation
(glwe.rs:197-271).
"""

from __future__ import annotations

import functools

import jax

from poulpy_tpu.core.layouts import GLWECiphertext, glwe_size
from poulpy_tpu.core.prepared import GGSWPrepared
from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import Module


@functools.partial(
    jax.jit, static_argnames=("module", "res_base2k", "res_k")
)
def glwe_external_product(
    module: Module,
    a: GLWECiphertext,
    ggsw: GGSWPrepared,
    res_base2k: int | None = None,
    res_k: int | None = None,
) -> GLWECiphertext:
    if module.mesh is not None:
        # mesh-attached Module: run the batch dp-sharded through the same
        # entry point with the mesh-less twin (parallel/auto.py)
        from poulpy_tpu.parallel.auto import dp_shard

        return dp_shard(
            module,
            lambda a_: glwe_external_product(
                module.local, a_, ggsw, res_base2k, res_k
            ),
            a,
        )
    res_base2k = a.base2k if res_base2k is None else res_base2k
    res_k = a.k if res_k is None else res_k
    res_size = glwe_size(res_base2k, res_k)

    if a.base2k != ggsw.base2k:
        from poulpy_tpu.core.keyswitching import glwe_normalize

        a = glwe_normalize(module, a, ggsw.base2k, a.k)

    dsize = ggsw.dsize
    a_size = a.size
    pmat = ggsw.pmat

    wide = dft.needs_wide(dft.product_bits(
        ggsw.base2k, ggsw.base2k, module.log_n, ggsw.dnum * (ggsw.rank + 1)
    ))
    if dsize == 1:
        a_dft = dft.dft_apply(module, a.data)
        res_dft = dft.vmp_apply(module, a_dft, pmat)
    else:
        dnum = ggsw.dnum
        res_dft = None
        for di in range(dsize):
            ai_size = min((a_size + di) // dsize, dnum)
            if ai_size == 0:
                continue
            ai = dft.dft_apply(
                module, a.data, step=dsize, offset=dsize - 1 - di, res_size=ai_size
            )
            part = dft.vmp_apply(module, ai, pmat, limb_offset=di)
            res_dft = part if res_dft is None else dft.dft_add(module, res_dft, part)

    if wide:
        pair = dft.idft_apply_wide(module, res_dft)
        res = dft.big_normalize_wide(
            module, res_size, res_base2k, pair, ggsw.base2k
        )
        return GLWECiphertext(data=res, base2k=res_base2k, k=res_k)
    res_big = dft.idft_apply(module, res_dft)
    res = dft.big_normalize(module, res_size, res_base2k, res_big, ggsw.base2k)
    return GLWECiphertext(data=res, base2k=res_base2k, k=res_k)


def glwe_cmux(
    module: Module,
    sel: GGSWPrepared,
    ct1: GLWECiphertext,
    ct0: GLWECiphertext,
) -> GLWECiphertext:
    """CMux(sel, ct1, ct0) = ct0 + sel ⊡ (ct1 − ct0) — the gate-bootstrap
    selector (bin-fhe Cmux trait, poulpy-bin-fhe/src/bdd_arithmetic/eval.rs:524)."""
    from poulpy_tpu.core.operations import glwe_add, glwe_sub

    diff = glwe_sub(ct1, ct0)
    prod = glwe_external_product(module, diff, sel, ct0.base2k, ct0.k)
    return glwe_add(ct0, prod)
