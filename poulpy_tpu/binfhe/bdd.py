"""BDD arithmetic on packed encrypted integers
(poulpy-bin-fhe/src/bdd_arithmetic/).

The reference ships ~18 kLoC of codegen'd static BDD tables for u32 ops
(src/bdd_arithmetic/circuits/u32/*_codegen.rs); here the BDDs are built
programmatically (carry-state construction for add/sub, Shannon products for
bitwise/shift/compare ops) — same circuits, derived instead of vendored.

Evaluation (eval.rs:104-230,524-606): every BDD node is a CMux
  node = sel ? hi : lo  =  lo + GGSW(sel) ⊡ (hi − lo)
with selectors the circuit-bootstrapped input bits and leaves trivial
encryptions of 0/1.  Bits of a `FheUint` are packed in one GLWE (bit j at
coefficient j, fhe_uint.rs:39,239); preparation extracts each bit to LWE and
circuit-bootstraps it into a GGSW selector — the reference threads this over
CPU cores (fhe_uint_prepared.rs:433), here it is a batched pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from poulpy_tpu.binfhe.circuit_bootstrapping import (
    CircuitBootstrappingKey,
    circuit_bootstrap,
)
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.conversion import lwe_from_glwe
from poulpy_tpu.core.external_product import glwe_cmux
from poulpy_tpu.core.layouts import GLWECiphertext, GLWEPlaintext, glwe_size
from poulpy_tpu.core.prepared import GGSWPrepared, ggsw_prepare
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import Module
from poulpy_tpu.utils import struct

# --------------------------------------------------------------------------
# BDD representation and builders
# --------------------------------------------------------------------------
#
# A circuit is a list of nodes; node = (var, lo, hi) where var is an input
# bit index and lo/hi reference earlier nodes or the leaves -1 (FALSE) and
# -2 (TRUE).  Variable convention for two w-bit operands: var 2i = a_i,
# var 2i+1 = b_i (LSB first).

FALSE, TRUE = -1, -2


@dataclass(frozen=True)
class BDD:
    nodes: tuple  # tuple of (var, lo, hi)
    root: int


class _Builder:
    def __init__(self):
        self.nodes = []
        self.cache = {}

    def mk(self, var, lo, hi):
        if lo == hi:
            return lo
        key = (var, lo, hi)
        if key not in self.cache:
            self.nodes.append(key)
            self.cache[key] = len(self.nodes) - 1
        return self.cache[key]

    def freeze(self, root) -> BDD:
        return BDD(nodes=tuple(self.nodes), root=root)


def _add_bit_bdd(width: int, out_bit: int, sub: bool = False) -> BDD:
    """Linear-size BDD for bit `out_bit` of a+b (or a−b): nodes track the
    carry/borrow state, variables LSB-first up to out_bit."""
    b = _Builder()
    memo = {}

    def build(i, carry_known, carry):
        # returns node computing s_out given carry into bit i
        key = (i, carry)
        if key in memo:
            return memo[key]
        if i == out_bit:
            # s = a_i xor b_i xor carry
            def leaf(ai, bi):
                return TRUE if (ai ^ bi ^ carry) else FALSE

            n_b0 = b.mk(2 * i + 1, leaf(0, 0), leaf(0, 1))
            n_b1 = b.mk(2 * i + 1, leaf(1, 0), leaf(1, 1))
            node = b.mk(2 * i, n_b0, n_b1)
        else:
            def next_carry(ai, bi):
                if sub:
                    # borrow: a_i - b_i - borrow
                    return 1 if (ai - bi - carry) < 0 else 0
                return 1 if (ai + bi + carry) >= 2 else 0

            n_b0 = None
            subs = {}
            for ai in (0, 1):
                lo = build(i + 1, True, next_carry(ai, 0))
                hi = build(i + 1, True, next_carry(ai, 1))
                subs[ai] = b.mk(2 * i + 1, lo, hi)
            node = b.mk(2 * i, subs[0], subs[1])
        memo[key] = node
        return node

    root = build(0, True, 0)
    return b.freeze(root)


def bdd_circuit(op: str, width: int) -> list[BDD]:
    """BDDs for all output bits of a two-operand op (the analogue of the
    reference's *_codegen tables, built on demand and cached)."""
    key = (op, width)
    if key in _CIRCUIT_CACHE:
        return _CIRCUIT_CACHE[key]
    if op == "add":
        out = [_add_bit_bdd(width, i, sub=False) for i in range(width)]
    elif op == "sub":
        out = [_add_bit_bdd(width, i, sub=True) for i in range(width)]
    elif op in ("and", "or", "xor"):
        fn = {
            "and": lambda a, b: a & b,
            "or": lambda a, b: a | b,
            "xor": lambda a, b: a ^ b,
        }[op]
        # bitwise: output bit i depends only on a_i, b_i
        out = []
        for i in range(width):
            bld = _Builder()
            def leaf(ai, bi):
                return TRUE if (fn(ai, bi) >> 0) & 1 else FALSE
            n_b0 = bld.mk(2 * i + 1, leaf(0, 0), leaf(0, 1))
            n_b1 = bld.mk(2 * i + 1, leaf(1, 0), leaf(1, 1))
            root = bld.mk(2 * i, n_b0, n_b1)
            out.append(bld.freeze(root))
    elif op in ("slt", "sltu"):
        out = [_cmp_bdd(width, op == "slt")]
    elif op in ("sll", "srl", "sra"):
        out = [_shift_bdd(width, i, op) for i in range(width)]
    elif op == "identity":
        # the 1w→1w refresh circuit (circuits/u32/identity_codgen.rs):
        # output bit i = a_i
        out = []
        for i in range(width):
            bld = _Builder()
            out.append(bld.freeze(bld.mk(2 * i, FALSE, TRUE)))
    else:
        raise ValueError(op)
    _CIRCUIT_CACHE[key] = out
    return out


def _cmp_bdd(width: int, signed: bool) -> BDD:
    """Linear-size comparison BDD (state: result decided / still equal),
    MSB-first."""
    b = _Builder()
    memo = {}

    def build(i):
        # compare from bit i downward assuming higher bits equal
        if i < 0:
            return FALSE  # equal → not less-than
        if i in memo:
            return memo[i]
        lower = build(i - 1)
        lt = TRUE
        gt = FALSE
        if signed and i == width - 1:
            lt, gt = gt, lt  # sign bit inverts the order
        # a_i=0: b_i=1 → lt ; b_i=0 → recurse
        n_a0 = b.mk(2 * i + 1, lower, lt)
        # a_i=1: b_i=1 → recurse ; b_i=0 → gt
        n_a1 = b.mk(2 * i + 1, gt, lower)
        node = b.mk(2 * i, n_a0, n_a1)
        memo[i] = node
        return node

    return b.freeze(build(width - 1))


_CIRCUIT_CACHE: dict = {}


# --------------------------------------------------------------------------
# FheUint
# --------------------------------------------------------------------------

@struct.dataclass
class FheUint:
    """All bits of a uint packed into one GLWE, bit j at coefficient j
    (bdd_arithmetic/ciphertexts/fhe_uint.rs:39).  A pytree like every
    other ciphertext layout, so it can cross jit boundaries as an
    argument."""

    glwe: GLWECiphertext
    width: int = struct.field(pytree_node=False)


@struct.dataclass
class FheUintPrepared:
    """Per-bit GGSW selectors (fhe_uint_prepared.rs:131).  Pytree (list
    of GGSWPrepared children, static width) — jit-passable."""

    bits: list[GGSWPrepared]
    width: int = struct.field(pytree_node=False)


@dataclass
class BDDKey:
    """{cbt, ks_glwe?, ks_lwe} bundle (bdd_arithmetic/key.rs:128-137).

    ks_glwe is the OPTIONAL GLWE→GLWE rank-reduction switching key
    (key.rs:64-66: present when the input ciphertext's GLWE rank differs
    from the bootstrapping key's); applied before bit extraction exactly
    as fhe_uint.rs get_bit_lwe:384-398."""

    cbt: CircuitBootstrappingKey
    ks_lwe: object  # GGLWEPrepared: GLWE→LWE switching key
    n_lwe: int
    base2k: int
    k_ct: int
    dnum_ggsw: int
    k_ggsw: int
    extension_factor: int = 1  # forwarded to the CBT blind rotation
    ks_glwe: object = None  # GGLWEPrepared rank-reduction key, or None


def fheuint_encrypt(
    module: Module, value: int, width: int, skp, base2k: int, k_ct: int,
    source_xe, source_xa,
) -> FheUint:
    bits = np.zeros(module.n, dtype=np.int64)
    for j in range(width):
        bits[j] = (value >> j) & 1
    size = glwe_size(base2k, k_ct)
    # bits at torus 1/4 (k=2): circuit bootstrapping with log_domain=1
    # needs phase b·2N/4 in the positive half-circle (b/2 would wrap)
    pt = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 2, size, jnp.asarray(bits)),
        base2k=base2k,
        k=2,
    )
    glwe = enc.glwe_encrypt_sk(module, pt, skp, base2k, k_ct, source_xe, source_xa)
    return FheUint(glwe=glwe, width=width)


def fheuint_decrypt(module: Module, ct: FheUint, skp) -> int:
    from poulpy_tpu.core import decryption as dec

    pt = dec.glwe_decrypt(module, ct.glwe, skp)
    bits = np.asarray(vec_znx.decode_vec_i64(ct.glwe.base2k, 2, pt.data))
    v = 0
    for j in range(ct.width):
        v |= (int(bits[j]) & 1) << j
    return v


def fheuint_prepare(
    module: Module, ct: FheUint, key: BDDKey
) -> FheUintPrepared:
    """Extract every bit to LWE and circuit-bootstrap ALL of them in ONE
    batched call (fhe_uint_prepared.rs:131-464 uses a thread pool per bit;
    here the width is a leading batch axis through rotate → keyswitch →
    sample-extract → circuit bootstrap, so one compiled pipeline prepares
    the whole integer)."""
    from poulpy_tpu.core.conversion import lwe_sample_extract
    from poulpy_tpu.core.keyswitching import glwe_keyswitch
    from poulpy_tpu.core.operations import glwe_rotate

    w = ct.width
    glwe = ct.glwe
    if key.ks_glwe is not None:
        # rank reduction first (get_bit_lwe, fhe_uint.rs:385-394): switch
        # the input to the bootstrapping key's rank before extraction
        glwe = glwe_keyswitch(module, glwe, key.ks_glwe, key.base2k,
                              key.k_ct)
    shifts = -jnp.arange(w, dtype=jnp.int64)[:, None, None]
    rot = glwe_rotate(shifts, glwe)             # [w, rank+1, size, N]
    ks = glwe_keyswitch(module, rot, key.ks_lwe, key.base2k, key.k_ct)
    lwe = lwe_sample_extract(ks, key.n_lwe, key.k_ct)
    ggsw = circuit_bootstrap(
        module, lwe, 1, key.cbt, dnum_res=key.dnum_ggsw,
        k_res=key.k_ggsw, to_exponent=False,
        extension_factor=key.extension_factor,
    )
    prepared = ggsw_prepare(module, ggsw)       # pmat [w, dnum, ., ., ., P, N]
    bits = [prepared.replace(pmat=prepared.pmat[j]) for j in range(w)]
    return FheUintPrepared(bits=bits, width=w)


def fheuint_prepared_encrypt_sk(
    module: Module,
    value: int,
    width: int,
    skp,
    base2k: int,
    k: int,
    dnum: int,
    source_xe,
    source_xa,
) -> FheUintPrepared:
    """Directly encrypt `value` into a FheUintPrepared — every bit as a
    constant-GGSW encryption, immediately prepared, with NO packed-GLWE
    FheUint intermediate (the testing/debug factory
    FheUintPreparedEncryptSk, fhe_uint_prepared.rs:176-225).

    All `width` bit-GGSWs encrypt through one batched keygen call (the bit
    index is a leading batch axis)."""
    from poulpy_tpu.core.encryption import ggsw_encrypt_sk

    bits_msb0 = jnp.asarray(
        [(value >> i) & 1 for i in range(width)], dtype=jnp.int64
    )
    pt = jnp.zeros((width, module.n), jnp.int64).at[:, 0].set(bits_msb0)
    ggsw = ggsw_encrypt_sk(
        module, pt, skp, base2k, k, dnum, source_xe, source_xa
    )
    prepared = ggsw_prepare(module, ggsw)
    bits = [prepared.replace(pmat=prepared.pmat[j]) for j in range(width)]
    return FheUintPrepared(bits=bits, width=width)


# --------------------------------------------------------------------------
# BDD evaluation
# --------------------------------------------------------------------------

def _trivial_bit(module: Module, bit: int, coeff: int, base2k: int, k: int, rank: int):
    """Trivial (noiseless) GLWE of bit·2^-2 at coefficient `coeff`."""
    size = glwe_size(base2k, k)
    data = jnp.zeros((rank + 1, size, module.n), jnp.int64)
    if bit:
        data = data.at[0, 0, coeff].set(1 << (base2k - 2))
    return GLWECiphertext(data=data, base2k=base2k, k=k)


def eval_bdd_bit(
    module: Module,
    bdd: BDD,
    sel_a: FheUintPrepared,
    sel_b: FheUintPrepared,
    out_coeff: int,
    base2k: int,
    k: int,
) -> GLWECiphertext:
    """Evaluate one output bit's BDD bottom-up with CMuxes
    (execute_bdd_circuit_2w_to_1w, eval.rs:104-230)."""
    rank = sel_a.bits[0].rank

    def leaf(code):
        return _trivial_bit(module, 1 if code == TRUE else 0, out_coeff, base2k, k, rank)

    cache: dict[int, GLWECiphertext] = {}

    def value(ref):
        if ref in (TRUE, FALSE):
            return leaf(ref)
        if ref in cache:
            return cache[ref]
        var, lo, hi = bdd.nodes[ref]
        bit_i, is_b = var // 2, var % 2
        sel = (sel_b if is_b else sel_a).bits[bit_i]
        out = glwe_cmux(module, sel, value(hi), value(lo))
        cache[ref] = out
        return out

    return value(bdd.root)


def fheuint_op(
    module: Module,
    op: str,
    a: FheUintPrepared,
    b: FheUintPrepared,
    base2k: int,
    k: int,
) -> GLWECiphertext:
    """Evaluate op(a, b), all output bits summed into one packed GLWE
    (each bit lands on its own coefficient, so plain addition packs)."""
    circuits = bdd_circuit(op, a.width)
    acc = None
    for j, bdd in enumerate(circuits):
        bit_ct = eval_bdd_bit(module, bdd, a, b, j, base2k, k)
        acc = bit_ct if acc is None else acc.replace(data=acc.data + bit_ct.data)
    from poulpy_tpu.hal.normalization import vec_znx_normalize

    return acc.replace(data=vec_znx_normalize(base2k, acc.data))


def fheuint_op_1w(
    module: Module,
    op: str,
    a: FheUintPrepared,
    base2k: int,
    k: int,
) -> GLWECiphertext:
    """One-operand circuit evaluation (execute_bdd_circuit_1w_to_1w,
    bdd_arithmetic/bdd_1w_to_1w.rs) — e.g. 'identity' re-packs prepared GGSW
    bits into a fresh (refreshed) packed FheUint GLWE."""
    return fheuint_op(module, op, a, a, base2k, k)


def eval_bdd_plain(bdd: BDD, a: int, b: int) -> int:
    """Reference evaluation on plaintext ints (circuit-construction oracle)."""

    def value(ref):
        if ref == TRUE:
            return 1
        if ref == FALSE:
            return 0
        var, lo, hi = bdd.nodes[ref]
        bit_i, is_b = var // 2, var % 2
        bit = ((b if is_b else a) >> bit_i) & 1
        return value(hi if bit else lo)

    return value(bdd.root)


def _shift_bdd(width: int, out_bit: int, kind: str) -> BDD:
    """Shift circuits (the reference's Sll/Srl/Sra codegen tables,
    bdd_arithmetic/circuits/u32/): operand a = data, operand b = shift
    amount (log2(width) bits used).  Shannon expansion over the amount bits
    selects which data bit (or 0 / sign bit) reaches `out_bit`."""
    logw = (width - 1).bit_length()
    b = _Builder()

    def src_bit(shift: int) -> int | None:
        if kind == "sll":
            j = out_bit - shift
            return j if j >= 0 else None
        if kind == "srl":
            j = out_bit + shift
            return j if j < width else None
        if kind == "sra":
            j = out_bit + shift
            return min(j, width - 1)
        raise ValueError(kind)

    def build(bit_idx: int, shift: int) -> int:
        if bit_idx < 0:
            j = src_bit(shift)
            if j is None:
                return FALSE
            # node testing data bit j (variable 2j)
            return b.mk(2 * j, FALSE, TRUE)
        lo = build(bit_idx - 1, shift)
        hi = build(bit_idx - 1, shift | (1 << bit_idx))
        return b.mk(2 * bit_idx + 1, lo, hi)  # amount bit = operand b

    return b.freeze(build(logw - 1, 0))


def bdd_shift_circuit(kind: str, width: int) -> list[BDD]:
    key = (kind, width)
    if key not in _CIRCUIT_CACHE:
        _CIRCUIT_CACHE[key] = [
            _shift_bdd(width, i, kind) for i in range(width)
        ]
    return _CIRCUIT_CACHE[key]


def blind_select(
    module: Module,
    selector_bits: "FheUintPrepared",
    options: list[GLWECiphertext],
) -> GLWECiphertext:
    """Blind retrieval of options[j] for encrypted index j
    (bdd_arithmetic/blind_retrieval.rs, blind_selection.rs): a CMux tree over
    the selector's GGSW bits."""
    from poulpy_tpu.core.external_product import glwe_cmux

    level = list(options)
    for bit in range(len(selector_bits.bits)):
        if len(level) == 1:
            break
        sel = selector_bits.bits[bit]
        nxt = []
        for i in range(0, len(level), 2):
            if i + 1 < len(level):
                nxt.append(glwe_cmux(module, sel, level[i + 1], level[i]))
            else:
                nxt.append(level[i])
        level = nxt
    return level[0]


def glwe_blind_rotation(
    module: Module,
    a: GLWECiphertext,
    k: "FheUintPrepared",
    sign: bool = False,
    bit_rsh: int = 0,
    bit_mask: int | None = None,
    bit_lsh: int = 0,
) -> GLWECiphertext:
    """res = a · X^{±((k >> bit_rsh) mod 2^bit_mask) << bit_lsh} for an
    encrypted exponent k (bdd_arithmetic/blind_rotation.rs GLWEBlindRotation):
    one CMux per selected exponent bit between the rotated and unrotated
    accumulator."""
    from poulpy_tpu.core.external_product import glwe_cmux
    from poulpy_tpu.core.operations import glwe_rotate

    nbits = (k.width - bit_rsh) if bit_mask is None else bit_mask
    res = a
    for i in range(nbits):
        bit = k.bits[bit_rsh + i]
        amt = 1 << (i + bit_lsh)
        rot = glwe_rotate(-amt if sign else amt, res)
        res = glwe_cmux(module, bit, rot, res)
    return res


def ggsw_blind_rotation(
    module: Module,
    a: "GGSWCiphertext",
    k: "FheUintPrepared",
    sign: bool = False,
    bit_rsh: int = 0,
    bit_mask: int | None = None,
    bit_lsh: int = 0,
):
    """GGSW counterpart (bdd_arithmetic/blind_rotation.rs GGSWBlindRotation):
    every (row, col_in) GLWE of the gadget matrix rotates by the same
    encrypted exponent.  The reference loops rows × cols; here (dnum, rank+1)
    are leading batch axes of ONE batched CMux chain."""
    rows = GLWECiphertext(data=a.data, base2k=a.base2k, k=a.k)
    out = glwe_blind_rotation(
        module, rows, k, sign=sign, bit_rsh=bit_rsh, bit_mask=bit_mask,
        bit_lsh=bit_lsh,
    )
    return a.replace(data=out.data)
