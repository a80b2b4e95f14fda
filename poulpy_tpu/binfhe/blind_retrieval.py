"""Streaming oblivious retrieval and conditional-swap networks.

Behavioral spec: poulpy-bin-fhe/src/bdd_arithmetic/blind_retrieval.rs —
``GLWEBlindRetriever`` (:31-130, binary carry-save streaming accumulator)
and the ``GLWEBlindRetrieval`` trait (:196-260, Cswap butterfly network);
Cswap itself from bdd_arithmetic/eval.rs:417-513.

Unlike :func:`poulpy_tpu.binfhe.bdd.blind_select` (a flat CMux tree that
needs every input materialized at once), the retriever consumes a *stream*
of GLWE ciphertexts one at a time and keeps only O(log n) live
ciphertexts: slot i holds the CMux-combination of a full aligned block of
2^i consecutive inputs, and two full blocks at the same level merge up —
exactly a binary carry-save counter.  For n inputs of which only
⌈log2 n⌉ + 1 fit in memory at once, this is a different capability class.

Batching: each GLWE may carry leading batch axes (every underlying op
broadcasts), so one ``add`` can stream a whole batch of independent
retrievals.  The butterfly network batches all pairs of a stage into ONE
external product along a stacked leading axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from poulpy_tpu.core.external_product import glwe_cmux, glwe_external_product
from poulpy_tpu.core.layouts import GLWECiphertext
from poulpy_tpu.core.operations import glwe_add, glwe_sub
from poulpy_tpu.hal.module import Module

__all__ = [
    "GLWEBlindRetriever",
    "glwe_cswap",
    "glwe_blind_retrieval",
    "glwe_blind_retrieval_rev",
    "glwe_blind_selection",
]


def _get_bit(selector, i):
    """Selector bit i: FheUintPrepared (.bits list) or a plain sequence of
    prepared GGSW bit encryptions (GetGGSWBit, bdd_arithmetic/eval.rs)."""
    bits = getattr(selector, "bits", selector)
    return bits[i]


def glwe_cswap(
    module: Module,
    a: GLWECiphertext,
    b: GLWECiphertext,
    sel,
) -> tuple[GLWECiphertext, GLWECiphertext]:
    """Conditional swap: (a, b) if sel=0, (b, a) if sel=1, via ONE external
    product shared by both outputs — d = sel ⊡ (b − a); a' = a + d;
    b' = b − d (Cswap, bdd_arithmetic/eval.rs:417-513)."""
    diff = glwe_sub(b, a)
    d = glwe_external_product(module, diff, sel, a.base2k, a.k)
    return glwe_add(a, d), glwe_sub(b, d)


class GLWEBlindRetriever:
    """Stateful accumulator retrieving one GLWE from a stream of inputs by
    an encrypted binary index (blind_retrieval.rs:31-130).

    ``capacity`` bounds the number of ``add`` calls between resets (the
    reference's ``alloc(infos, size)``); state is ⌈log2 capacity⌉ slots,
    each either empty or holding one combined GLWE.  The result of
    ``flush`` encrypts ``data[idx]`` where idx is the value encrypted in
    the selector bits ``offset..offset+nbits`` (bit i chooses the
    higher-index half of each 2^(i+1)-aligned block).

    The combine schedule is the same binary tree as ``blind_select``'s, so
    for identical inputs/keys the results are bit-exact equal — streamed.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        nbits = max(1, (capacity - 1).bit_length())
        # slot = (data | None, num in {0, 1}); data may outlive num=0 at the
        # top level, where flush reads it unconditionally (ref :117)
        self._slots: list[list] = [[None, 0] for _ in range(nbits)]
        # enforce the REQUESTED size, not the power-of-two slot count —
        # alloc(infos, size) callers rely on add #size+1 panicking
        self.capacity = capacity
        self.counter = 0

    def reset(self) -> None:
        for s in self._slots:
            s[1] = 0
        self.counter = 0

    def _add_core(self, module, a, i, selector, offset):
        """Carry-propagate a combined block of 2^i inputs into slot i
        (blind_retrieval.rs add_core :150-186, iterative form)."""
        slots = self._slots
        while i < len(slots):
            if slots[i][1] == 0:
                slots[i][0], slots[i][1] = a, 1
                return
            bit = _get_bit(selector, i + offset)
            # select the streamed-later (higher-index) operand when bit=1
            a = glwe_cmux(module, bit, a, slots[i][0])
            slots[i][0], slots[i][1] = a, 0
            i += 1

    def add(self, module: Module, ct: GLWECiphertext, selector,
            offset: int = 0) -> None:
        """Stream in the next input ciphertext."""
        if self.counter >= self.capacity:
            raise ValueError(
                f"Accumulating limit of {self.capacity} reached"
            )
        self._add_core(module, ct, 0, selector, offset)
        self.counter += 1

    def flush(self, module: Module, selector, offset: int = 0
              ) -> GLWECiphertext:
        """Merge partial blocks upward and return the retrieved GLWE
        (blind_retrieval.rs flush :98-121).

        DEVIATION from the reference: flushing an EMPTY accumulator raises
        (the reference returns an encryption of zero, :103-107, which it
        can mint from its ``alloc(infos, size)`` prototype; this retriever
        carries no GLWE prototype, so there is nothing to shape a zero
        ciphertext from).  Stream at least one input before flushing."""
        if self.counter == 0:
            raise ValueError(
                "flush with no accumulated inputs (reference returns a "
                "zero GLWE here; see docstring for why this deviates)"
            )
        slots = self._slots
        for i in range(len(slots) - 1):
            if slots[i][1] != 0:
                self._add_core(module, slots[i][0], i + 1, selector, offset)
                slots[i][1] = 0
        res = slots[-1][0]
        self.reset()
        return res

    def retrieve(self, module: Module, data, selector, offset: int = 0
                 ) -> GLWECiphertext:
        """reset + add(each) + flush in one call (ref :57-77)."""
        self.reset()
        for ct in data:
            self.add(module, ct, selector, offset)
        return self.flush(module, selector, offset)


def _batched_cswap_stage(module, res, pairs, bit):
    """One butterfly stage: all (lo, hi) pairs share the same selector bit,
    so they stack along a fresh leading batch axis and pay ONE batched
    external product instead of len(pairs) dispatches."""
    if len(pairs) == 1:
        j, jt = pairs[0]
        res[j], res[jt] = glwe_cswap(module, res[j], res[jt], bit)
        return
    lo = res[pairs[0][0]]
    lo_stack = lo.replace(data=jnp.stack([res[j].data for j, _ in pairs]))
    hi_stack = lo.replace(data=jnp.stack([res[jt].data for _, jt in pairs]))
    lo2, hi2 = glwe_cswap(module, lo_stack, hi_stack, bit)
    for p, (j, jt) in enumerate(pairs):
        res[j] = lo.replace(data=lo2.data[p])
        res[jt] = lo.replace(data=hi2.data[p])


def glwe_blind_selection(
    module: Module,
    a: dict,
    selector,
    bit_rsh: int = 0,
    bit_mask: int | None = None,
) -> GLWECiphertext:
    """Oblivious selection from an encrypted-indexed MAP: returns the GLWE
    at key ``(idx >> bit_rsh) % 2^bit_mask`` for the encrypted selector
    idx; indices absent from the map act as encryptions of zero
    (GLWEBlindSelection, bdd_arithmetic/blind_selection.rs:13-120; MSB→LSB
    binary-tree CMux reduction)."""
    if not a:
        raise ValueError("blind_selection: empty map")
    if bit_mask is None:
        bit_mask = len(getattr(selector, "bits", selector)) - bit_rsh
    entries = dict(a)
    proto = next(iter(entries.values()))
    zero = proto.replace(data=jnp.zeros_like(proto.data))
    for i in range(bit_mask):
        t = 1 << (bit_mask - i - 1)
        bit = _get_bit(selector, bit_rsh + bit_mask - i - 1)
        for j in range(t):
            low = entries.pop(j, None)
            high = entries.pop(j + t, None)
            if low is None and high is None:
                continue
            entries[j] = glwe_cmux(
                module, bit,
                zero if high is None else high,   # selected when bit = 1
                zero if low is None else low,
            )
    return entries.get(0, zero)


def _butterfly(module, cts, selector, bit_rsh, bit_mask, reverse):
    if bit_mask is None:
        bit_mask = len(getattr(selector, "bits", selector)) - bit_rsh
    res = list(cts)
    stages = range(bit_mask)
    for i in (reversed(stages) if reverse else stages):
        t = 1 << (bit_mask - i - 1)
        bit = _get_bit(selector, bit_rsh + bit_mask - i - 1)
        pairs = [(j, j + t) for j in range(t) if j + t < len(res)]
        if pairs:
            _batched_cswap_stage(module, res, pairs, bit)
    return res


def glwe_blind_retrieval(
    module: Module,
    cts: list[GLWECiphertext],
    selector,
    bit_rsh: int = 0,
    bit_mask: int | None = None,
) -> list[GLWECiphertext]:
    """Butterfly-network oblivious rearrangement: returns a list whose
    element 0 encrypts ``cts[(idx >> bit_rsh) % 2^bit_mask]`` for the
    encrypted selector idx (glwe_blind_retrieval_statefull,
    blind_retrieval.rs:224-247; MSB→LSB Cswap stages)."""
    return _butterfly(module, cts, selector, bit_rsh, bit_mask,
                      reverse=False)


def glwe_blind_retrieval_rev(
    module: Module,
    cts: list[GLWECiphertext],
    selector,
    bit_rsh: int = 0,
    bit_mask: int | None = None,
) -> list[GLWECiphertext]:
    """Applies the butterfly stages in reverse order, undoing
    :func:`glwe_blind_retrieval`'s permutation up to noise
    (glwe_blind_retrieval_statefull_rev, blind_retrieval.rs:252-275)."""
    return _butterfly(module, cts, selector, bit_rsh, bit_mask,
                      reverse=True)
