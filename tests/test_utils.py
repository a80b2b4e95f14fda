"""utils.struct (the pytree dataclasses every layout is built on) and
utils.compile_cache (where the persistent compilation cache lives)."""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from poulpy_tpu.utils import compile_cache, struct


@struct.dataclass
class _Pair:
    x: jnp.ndarray
    y: jnp.ndarray
    tag: str = struct.field(pytree_node=False, default="a")
    scale: int = struct.field(pytree_node=False, default=1)


def _pair(tag="a"):
    return _Pair(x=jnp.arange(4), y=jnp.ones((2, 3), jnp.int64), tag=tag)


def test_struct_flatten_unflatten_roundtrip():
    p = _pair()
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                     # static fields are not leaves
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, _Pair) and (q.tag, q.scale) == ("a", 1)
    assert np.array_equal(q.x, p.x) and np.array_equal(q.y, p.y)


def test_struct_static_fields_live_in_the_treedef():
    a, b = _pair("a"), _pair("b")
    assert jax.tree.structure(a) != jax.tree.structure(b)
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)
        return p.x.sum() * p.scale

    f(a), f(a), f(b)
    assert traces == ["a", "b"]                 # one trace per static value


def test_struct_replace_and_frozen():
    p = _pair()
    q = p.replace(tag="z", x=jnp.zeros(4, jnp.int64))
    assert (p.tag, q.tag) == ("a", "z")
    assert np.array_equal(p.x, jnp.arange(4)) and not q.x.any()
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.tag = "b"


def test_struct_crosses_jit_and_vmap():
    p = _pair().replace(scale=3)
    out = jax.jit(lambda p: p.replace(x=p.x * p.scale))(p)
    assert isinstance(out, _Pair) and out.scale == 3
    assert np.array_equal(out.x, jnp.arange(4) * 3)
    batched = _Pair(x=jnp.ones((5, 4)), y=jnp.ones((5, 2)), tag="v")
    sums = jax.vmap(lambda p: p.x.sum() + p.y.sum())(batched)
    assert sums.shape == (5,)


def _layouts():
    from poulpy_tpu.binfhe.lut import LookupTable
    from poulpy_tpu.ckks.layouts import CKKSCiphertext, CKKSMeta
    from poulpy_tpu.core.layouts import GLWECiphertext, LWECiphertext
    from poulpy_tpu.core.prepared import (
        GGLWEPrepared,
        GGSWPrepared,
        GLWETensorKeyPrepared,
    )

    z = jnp.zeros((2, 2, 3, 8), jnp.int64)
    pm = jnp.zeros((3, 2, 2, 4, 2, 8), jnp.int32)
    glwe = GLWECiphertext(data=z, base2k=17, k=51)
    return {
        "glwe": glwe,
        "lwe": LWECiphertext(data=z[:, 0], base2k=17, k=34),
        "ggsw": GGSWPrepared(pmat=pm, base2k=17, k=68, dsize=2),
        "lut": LookupTable(data=z[0], base2k=17, k=34, drift=3),
        "ckks": CKKSCiphertext(
            glwe=glwe, meta=CKKSMeta(log_delta=22, log_budget=30)),
        "tensor_key": GLWETensorKeyPrepared(keys={
            (0, 0): GGLWEPrepared(pmat=pm[:, :1], base2k=17, k=68)}),
    }


@pytest.mark.parametrize("name", list(_layouts()))
def test_layouts_are_pytrees(name):
    """Every layout class round-trips through flatten/unflatten and a jit
    boundary with its one array as the leaf and its metadata (static
    fields, nested static dataclasses, dict keys) in the treedef."""
    obj = _layouts()[name]
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    assert len(leaves) == 1
    back = jax.jit(lambda o: o)(obj)
    assert type(back) is type(obj)
    assert jax.tree.structure(back) == treedef
    assert np.array_equal(jax.tree.leaves(back)[0], leaves[0])


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    try:
        assert compile_cache.compile_cache_dir() == str(tmp_path)
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    repo = Path(__file__).resolve().parents[1]
    path = compile_cache.compile_cache_dir()
    assert path == str(repo / ".jax_cache")
    assert compile_cache.compile_cache_dir() == path   # no pid, no clock
    gitignore = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in gitignore


def test_compile_cache_empty_env_falls_back(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "")
    assert compile_cache.compile_cache_dir() == str(
        compile_cache.DEFAULT_DIR)
    assert os.path.isabs(compile_cache.compile_cache_dir())
