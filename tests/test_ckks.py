"""CKKS leveled-evaluator tests (mirroring poulpy-ckks test_suite:
add/sub/mul/mul_plain/rescale/rotate/conjugate/composite vs f64 reference
computation on the slots)."""

import numpy as np
import pytest

import jax.numpy as jnp

from poulpy_tpu.ckks import ops as ck
from poulpy_tpu.ckks.encoder import Encoder
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.prepared import (
    GLWEAutomorphismKeyPrepared,
    gglwe_prepare,
    glwe_secret_prepare,
    glwe_tensor_key_prepare,
)
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source

N = 64
BASE2K = 17
K_CT = 119         # 7 limbs: must exceed the mul landing shift by a
                   # noise margin (reference params use k=95 vs eff=35,
                   # poulpy-ckks/examples/poly2.rs:48-61)
LOG_DELTA = 22
LOG_BUDGET = 30    # effective_k = 52
K_KEY = 119
RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def ctx():
    m = get_module(N, 4)
    s = Source(bytes(32))
    sk = enc.secret_new(m, 1, s)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(
        m,
        enc.glwe_tensor_key_encrypt_sk(
            m, sk, skp, BASE2K, K_KEY, dnum=7, source_xe=xe, source_xa=xa
        ),
    )
    encd = Encoder(N)
    return m, sk, skp, tsk, encd


def rand_slots():
    return RNG.normal(size=N // 2) + 1j * RNG.normal(size=N // 2)


def enc_ct(ctx, z, log_budget=LOG_BUDGET):
    m, sk, skp, tsk, encd = ctx
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    pt = ck.encode(encd, z, BASE2K, K_CT, LOG_DELTA, log_budget)
    return ck.encrypt_sk(m, pt, skp, K_CT, xe, xa)


def dec_slots(ctx, ct):
    m, sk, skp, tsk, encd = ctx
    return ck.decode(encd, ck.decrypt(m, ct, skp))


def test_encode_encrypt_roundtrip(ctx):
    z = rand_slots()
    got = dec_slots(ctx, enc_ct(ctx, z))
    assert np.abs(got - z).max() < 4e-6


def test_add_sub(ctx):
    z1, z2 = rand_slots(), rand_slots()
    c1, c2 = enc_ct(ctx, z1), enc_ct(ctx, z2)
    assert np.abs(dec_slots(ctx, ck.add(c1, c2)) - (z1 + z2)).max() < 4e-6
    assert np.abs(dec_slots(ctx, ck.sub(c1, c2)) - (z1 - z2)).max() < 4e-6
    assert np.abs(dec_slots(ctx, ck.negate(c1)) + z1).max() < 4e-6


def test_rescale_budget(ctx):
    z = rand_slots()
    c = enc_ct(ctx, z)
    r = ck.rescale(c, 5)
    assert r.log_budget == c.log_budget - 5
    assert np.abs(dec_slots(ctx, r) - z).max() < 4e-6


def test_mul(ctx):
    m, sk, skp, tsk, encd = ctx
    z1, z2 = rand_slots(), rand_slots()
    c1, c2 = enc_ct(ctx, z1), enc_ct(ctx, z2)
    prod = ck.mul(m, c1, c2, tsk)
    assert prod.log_delta == LOG_DELTA
    assert prod.log_budget == LOG_BUDGET - LOG_DELTA
    got = dec_slots(ctx, prod)
    assert np.abs(got - z1 * z2).max() < 1e-4, np.abs(got - z1 * z2).max()


def test_mul_plain(ctx):
    m, sk, skp, tsk, encd = ctx
    z1, z2 = rand_slots(), rand_slots()
    c1 = enc_ct(ctx, z1)
    pt2 = ck.encode(encd, z2, BASE2K, K_CT, LOG_DELTA, LOG_BUDGET)
    prod = ck.mul_plain(m, c1, pt2)
    got = dec_slots(ctx, prod)
    assert np.abs(got - z1 * z2).max() < 1e-4


def test_mul_add_budget_error(ctx):
    m, sk, skp, tsk, encd = ctx
    z = rand_slots()
    c = enc_ct(ctx, z, log_budget=10)  # budget < delta
    with pytest.raises(ck.CKKSError):
        ck.mul(m, c, c, tsk)


def test_rotate_conjugate(ctx):
    m, sk, skp, tsk, encd = ctx
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    z = rand_slots()
    c = enc_ct(ctx, z)
    # rotation by one slot: galois element 5
    p = m.galois_element(1)
    key, _ = enc.glwe_automorphism_key_encrypt_sk(
        m, p, sk, BASE2K, K_KEY, dnum=7, source_xe=xe, source_xa=xa
    )
    akp = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, key), p=p)
    rot = ck.rotate(m, c, akp)
    got = dec_slots(ctx, rot)
    want = np.roll(z, -1)
    assert np.abs(got - want).max() < 1e-4, np.abs(got - want).max()

    # conjugation: galois element -1
    pc = -1
    keyc, _ = enc.glwe_automorphism_key_encrypt_sk(
        m, pc, sk, BASE2K, K_KEY, dnum=7, source_xe=xe, source_xa=xa
    )
    akc = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, keyc), p=pc)
    conj = ck.conjugate(m, c, akc)
    gotc = dec_slots(ctx, conj)
    assert np.abs(gotc - np.conj(z)).max() < 1e-4


def test_composite(ctx):
    m, sk, skp, tsk, encd = ctx
    z1, z2, z3 = rand_slots(), rand_slots(), rand_slots()
    c1, c2, c3 = enc_ct(ctx, z1), enc_ct(ctx, z2), enc_ct(ctx, z3)
    # mul_add: c1*c2 + c3 needs c3 aligned to the product's budget
    got = dec_slots(ctx, ck.mul_add(m, c1, c2, ck.rescale(c3, 0), tsk))
    # NOTE: add aligns budgets via rescale internally
    want = z1 * z2 + z3
    assert np.abs(got - want).max() < 1e-3


def test_error_taxonomy():
    """Typed composition errors mirror poulpy-ckks/src/error.rs variants."""
    from poulpy_tpu.ckks import ops

    with pytest.raises(ops.InsufficientHomomorphicCapacity):
        ops._checked_sub("rescale", 5, 10)
    with pytest.raises(ops.MissingAutomorphismKey):
        ops.rotate_by(None, None, {}, 3)
    assert issubclass(ops.PlaintextBase2KMismatch, ops.CKKSError)
    assert issubclass(ops.PlaintextAlignmentImpossible, ops.CKKSError)


def test_mul_div_pow2(ctx):
    """pow2 meta-aware scaling (leveled/default/pow2.rs:26-80)."""
    z = rand_slots()
    c = enc_ct(ctx, z)
    up = ck.mul_pow2(c, 3)
    assert up.meta.log_delta == c.meta.log_delta
    assert up.log_budget == c.log_budget
    assert np.abs(dec_slots(ctx, up) - 8 * z).max() < 4e-5

    dn = ck.div_pow2(c, 3)
    assert dn.meta.log_delta == c.meta.log_delta + 3
    assert dn.log_budget == c.log_budget - 3
    assert np.abs(dec_slots(ctx, dn) - z / 8).max() < 4e-6

    # mul_pow2 then div_pow2 round-trips the value (budget pays)
    rt = ck.div_pow2(ck.mul_pow2(c, 4), 4)
    assert np.abs(dec_slots(ctx, rt) - z).max() < 4e-6


def test_mul_chain_depth3_rank2():
    """Depth-3 multiply chain at rank 2 (the reference test_suite covers
    leveled composition; rank-2 exercises the full tensor-key triangle
    (0,0),(0,1),(1,1)).

    Parameter note: the first mul's landing shift is 2·eff − δ = 2·78 − 18
    = 138 bits, and the mask-wrap cross-terms (see CLAUDE.md / the
    big-rational oracle analysis in test_core) demand k_ct exceed it by a
    wide noise margin — hence k = 153 (9 limbs), mirroring the reference's
    k=95-vs-eff=35 headroom (poulpy-ckks/examples/poly2.rs:48-61)."""
    m = get_module(N, 4)
    k_ct = k_key = 153
    delta, log_budget = 18, 60   # 3 muls consume 3·18 = 54 budget bits
    s = Source(b"\x21" * 32)
    sk = enc.secret_new(m, 2, s)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x22" * 32), Source(b"\x23" * 32)
    tsk = glwe_tensor_key_prepare(
        m,
        enc.glwe_tensor_key_encrypt_sk(
            m, sk, skp, BASE2K, k_key, dnum=9, source_xe=xe, source_xa=xa
        ),
    )
    encd = Encoder(N)
    zs = [0.5 * rand_slots() for _ in range(4)]
    cts = []
    for z in zs:
        pt = ck.encode(encd, z, BASE2K, k_ct, delta, log_budget)
        cts.append(ck.encrypt_sk(m, pt, skp, k_ct, xe, xa))
    out = cts[0]
    want = zs[0]
    for i in range(1, 4):
        out = ck.mul(m, out, cts[i], tsk)
        want = want * zs[i]
    assert out.log_budget == log_budget - 3 * delta
    assert out.glwe.rank == 2
    pt = ck.decrypt(m, out, skp)
    got = ck.decode(encd, pt)
    assert np.abs(got - want).max() < 5e-4, np.abs(got - want).max()


def test_mul_many_balanced_tree():
    """composite.rs ckks_mul_many (delegates/composite.rs mul_many_rec):
    4-operand product == slotwise product; budget pays only the tree DEPTH
    (2 muls' worth), not n-1 as a left fold would.

    Parameters mirror test_mul_chain_depth3_rank2: k=153/δ=18/budget=60
    keeps the mask-wrap landing margin wide enough for a multi-mul chain
    (CLAUDE.md noise-margin rule)."""
    m = get_module(N, 4)
    k_ct = k_key = 153
    delta, log_budget = 18, 60
    s = Source(b"\x24" * 32)
    sk = enc.secret_new(m, 1, s)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x25" * 32), Source(b"\x26" * 32)
    tsk = glwe_tensor_key_prepare(
        m,
        enc.glwe_tensor_key_encrypt_sk(
            m, sk, skp, BASE2K, k_key, dnum=9, source_xe=xe, source_xa=xa
        ),
    )
    encd = Encoder(N)
    zs = [rand_slots() * 0.5 for _ in range(4)]
    cts = []
    for z in zs:
        pt = ck.encode(encd, z, BASE2K, k_ct, delta, log_budget)
        cts.append(ck.encrypt_sk(m, pt, skp, k_ct, xe, xa))

    def dec_slots_local(ct):
        return ck.decode(encd, ck.decrypt(m, ct, skp))

    out = ck.mul_many(m, cts, tsk)
    want = zs[0] * zs[1] * zs[2] * zs[3]
    assert np.abs(dec_slots_local(out) - want).max() < 2e-3

    # depth accounting: tree budget == the budget of (a*b) * (c*d), i.e.
    # TWO muls' worth of Δ — a left fold over 4 cts would pay three
    ab = ck.mul(m, cts[0], cts[1], tsk)
    cd = ck.mul(m, cts[2], cts[3], tsk)
    two_level = ck.mul(m, ab, cd, tsk)
    assert out.log_budget == two_level.log_budget

    # degenerate sizes + mismatched-delta guard
    assert ck.mul_many(m, [cts[0]], tsk) is cts[0]
    with pytest.raises(ValueError, match="at least one"):
        ck.mul_many(m, [], tsk)
    odd = ck.mul_many(m, cts[:3], tsk)
    assert np.abs(dec_slots_local(odd) - zs[0] * zs[1] * zs[2]).max() < 2e-3


def test_vec_rnx_plaintext_forms(ctx):
    """layouts/plaintext/vec.rs VecRnx: float coefficient polynomial
    quantizes to a VecZnx (to_znx:273) and back (decode_from_znx), and
    drives ct×pt through the convolution path with the expected noise."""
    from poulpy_tpu.ckks import plaintext as ptf

    m, sk, skp, tsk, encd = ctx
    # float poly whose slot transform is easy to model: use the encoder to
    # go slots -> coefficient floats
    z = rand_slots()
    coeffs_f = encd.encode_rnx(z)  # unscaled float poly (VecRnx form)
    rnx = ptf.CKKSPlaintextVecRnx(coeffs=jnp.asarray(coeffs_f))

    meta = ck.CKKSMeta(log_delta=LOG_DELTA, log_budget=8)
    # quantize -> dequantize round trip: error <= 0.5 ulp of 2^-log_delta
    znx = ptf.vec_rnx_to_znx(rnx, BASE2K, meta.effective_k, meta)
    back = ptf.vec_rnx_from_znx(znx)
    assert np.abs(np.asarray(back.coeffs) - coeffs_f).max() <= 2.0 ** -LOG_DELTA

    # ct x float-pt == slotwise product (within quantization+ct noise)
    z2 = rand_slots()
    c2 = enc_ct(ctx, z2)
    out = ptf.mul_plain_rnx(m, c2, rnx, meta)
    want = z * z2
    got = dec_slots(ctx, out)
    assert np.abs(got - want).max() < 2e-3
    assert out.log_budget == c2.log_budget - LOG_DELTA


def test_cst_plaintext_forms(ctx):
    """cst.rs CstRnx/CstZnx: real, imaginary, and complex scalar constants;
    im rides the X^{N/2} rotation (mul.rs:343-376)."""
    from poulpy_tpu.ckks import plaintext as ptf

    m, sk, skp, tsk, encd = ctx
    z = rand_slots()
    meta = ck.CKKSMeta(log_delta=20, log_budget=0)
    for re, im in [(1.75, None), (None, 0.5), (0.3, -1.25)]:
        c = enc_ct(ctx, z)
        cst = ptf.CKKSPlaintextCstRnx(re=re, im=im)
        out = ptf.mul_cst_rnx(m, c, cst, meta)
        scalar = (re or 0.0) + 1j * (im or 0.0)
        got = dec_slots(ctx, out)
        assert np.abs(got - z * scalar).max() < 1e-4, (re, im)
        assert out.log_budget == c.log_budget - 20

    # quantized CstZnx is the integer pair at the meta scale
    czx = ptf.cst_rnx_to_znx(ptf.CKKSPlaintextCstRnx(re=0.3, im=-1.25), meta)
    assert czx.re == round(0.3 * 2**20) and czx.im == round(-1.25 * 2**20)


def test_mul_add_const_scalar(ctx):
    """mul_const / add_const scalar semantics (CstRnx consumption paths):
    slot values scale/shift exactly (regression — the original mul_const
    divided the constant's scale out twice, add_const entered at the wrong
    scale; both decoded garbage)."""
    m, sk, skp, tsk, encd = ctx
    z = rand_slots()
    c = enc_ct(ctx, z)
    out = ck.mul_const(c, 1.75, 20)
    assert out.log_budget == c.log_budget - 20
    assert np.abs(dec_slots(ctx, out) - z * 1.75).max() < 1e-4

    out2 = ck.add_const(c, 0.625)
    assert np.abs(dec_slots(ctx, out2) - (z + 0.625)).max() < 4e-6


def test_rotate_many_r_and_ordering(ctx):
    """Slot-rotation semantics pinned for several r:
    encode→rotate(r)→decode == np.roll(slots, -r) through encryption with
    automorphism keys, plus encoder-level orbit checks documenting the
    ordering contract.

    Ordering note: this encoder indexes slots along the generator orbit
    t_k = 5^k mod 2N DIRECTLY (ckks/encoder.py); the reference stores the
    same orbit in bit-reversed table order (poulpy-ckks/src/encoding/
    reim.rs:31-38).  The two slot layouts differ by that fixed
    bit-reversal permutation, and under BOTH, X→X^{5^r} rotates slots
    cyclically — which these tests pin down."""
    m, sk, skp, tsk, encd = ctx
    xe, xa = Source(b"\x27" * 32), Source(b"\x28" * 32)
    z = rand_slots()
    c = enc_ct(ctx, z)
    for r in [1, 2, 5, -1]:
        p = m.galois_element(r)
        key, _ = enc.glwe_automorphism_key_encrypt_sk(
            m, p, sk, BASE2K, K_KEY, dnum=7, source_xe=xe, source_xa=xa
        )
        akp = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, key), p=p)
        got = dec_slots(ctx, ck.rotate(m, c, akp))
        want = np.roll(z, -r)
        assert np.abs(got - want).max() < 1e-4, r

    # plaintext-level orbit contract: applying X→X^{5^r} to the encoded
    # coefficients rolls the slot vector (no encryption, no key noise)
    from poulpy_tpu.hal.vec_znx import vec_znx_automorphism

    coeffs = encd.encode(z, 30)
    for r in [1, 3]:
        p = m.galois_element(r)
        rolled = np.asarray(vec_znx_automorphism(p, jnp.asarray(coeffs)))
        got = encd.decode(rolled, 30)
        assert np.abs(got - np.roll(z, -r)).max() < 1e-6, r
    # conjugation = X→X^{-1}
    pm1 = vec_znx_automorphism(2 * m.n - 1, jnp.asarray(coeffs))
    assert np.abs(encd.decode(np.asarray(pm1), 30) - np.conj(z)).max() < 1e-6


def test_mul_sub_and_dot_product(ctx):
    """Remaining composite ops vs f64 slot reference (leveled test_suite
    mul_sub / dot_product rows)."""
    m, sk, skp, tsk, encd = ctx
    z1, z2, z3 = rand_slots(), rand_slots(), rand_slots()
    c1, c2, c3 = enc_ct(ctx, z1), enc_ct(ctx, z2), enc_ct(ctx, z3)
    got = dec_slots(ctx, ck.mul_sub(m, c1, c2, ck.rescale(c3, 0), tsk))
    assert np.abs(got - (z1 * z2 - z3)).max() < 1e-3

    xs = [enc_ct(ctx, z) for z in (z1, z2)]
    ys = [enc_ct(ctx, z) for z in (z3, z1)]
    got = dec_slots(ctx, ck.dot_product(m, xs, ys, tsk))
    want = z1 * z3 + z2 * z1
    assert np.abs(got - want).max() < 1e-3
