"""Layout serialization (poulpy-hal/src/layouts/serialization.rs:7-18).

Same wire philosophy as the reference `WriterTo`/`ReaderFrom`: little-endian
u64 header fields (a magic/version pair plus the layout metadata), then the
raw coefficient payload; readers validate the header before committing
(vec_znx.rs:339-398 pattern).  Works on any of the pytree layouts in
core/ckks/binfhe — static metadata is taken from the dataclass fields.
"""

from __future__ import annotations

import struct as _struct

import jax.numpy as jnp
import numpy as np

MAGIC = 0x504C5059_54505500  # "PLPYTPU\0"
VERSION = 1


def write_array(buf: bytearray, arr) -> None:
    a = np.asarray(arr)
    buf += _struct.pack("<QQ", MAGIC, VERSION)
    buf += _struct.pack("<Q", a.ndim)
    for d in a.shape:
        buf += _struct.pack("<Q", d)
    dt = {"int64": 0, "int32": 1, "float64": 2}[a.dtype.name]
    buf += _struct.pack("<Q", dt)
    buf += a.astype(a.dtype.newbyteorder("<")).tobytes()


def read_array(view: memoryview):
    magic, version = _struct.unpack_from("<QQ", view, 0)
    if magic != MAGIC:
        raise ValueError("bad magic")
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    ndim = _struct.unpack_from("<Q", view, 16)[0]
    off = 24
    shape = []
    for _ in range(ndim):
        shape.append(_struct.unpack_from("<Q", view, off)[0])
        off += 8
    dt = _struct.unpack_from("<Q", view, off)[0]
    off += 8
    dtype = {0: np.int64, 1: np.int32, 2: np.float64}[dt]
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(view, dtype=np.dtype(dtype).newbyteorder("<"),
                        count=count, offset=off).reshape(shape)
    return jnp.asarray(arr), off + arr.nbytes


def serialize_layout(obj) -> bytes:
    """Serialize a layout dataclass (arrays + static metadata).

    Nested layout dataclasses (e.g. CKKSCiphertext.glwe/meta) recurse:
    their blob is embedded length-prefixed and tagged with the nested
    class name in the metadata header."""
    import dataclasses

    buf = bytearray()
    fields = dataclasses.fields(obj)
    meta = {}
    arrays = []
    nested = []
    for f in fields:
        v = getattr(obj, f.name)
        if isinstance(v, bytes):
            meta[f.name] = {"__bytes__": v.hex()}  # compressed-layer seeds
        elif v is None:
            meta[f.name] = {"__none__": True}
        elif isinstance(v, (bool, int, float, str)):
            meta[f.name] = v
        elif dataclasses.is_dataclass(v):
            # qualified path: two layout classes sharing a bare name in
            # different modules must not alias on deserialize
            meta[f.name] = {
                "__nested__": f"{type(v).__module__}.{type(v).__name__}"
            }
            nested.append((f.name, v))
        else:
            arrays.append((f.name, v))
    import json

    mb = json.dumps({"type": type(obj).__name__, "meta": meta}).encode()
    buf += _struct.pack("<Q", len(mb))
    buf += mb
    for name, v in arrays:
        nb = name.encode()
        buf += _struct.pack("<Q", len(nb))
        buf += nb
        write_array(buf, v)
    for name, v in nested:
        nb = name.encode()
        buf += _struct.pack("<Q", len(nb))
        buf += nb
        blob = serialize_layout(v)
        buf += _struct.pack("<QQ", _NESTED_TAG, len(blob))
        buf += blob
    return bytes(buf)


_NESTED_TAG = 0x4E45535445440000  # "NESTED\0\0" — disambiguates from MAGIC


def _resolve_layout_class(name: str):
    """Resolve a nested layout class: qualified ``module.Class`` names
    import directly; bare names (v1 blobs) fall back to a search across
    the package's layout modules."""
    import dataclasses
    import importlib

    if "." in name:
        modname, clsname = name.rsplit(".", 1)
        cls = getattr(importlib.import_module(modname), clsname, None)
        if cls is None or not dataclasses.is_dataclass(cls):
            raise ValueError(f"unknown nested layout class {name!r}")
        return cls
    for modname in (
        "poulpy_tpu.core.layouts", "poulpy_tpu.core.compressed",
        "poulpy_tpu.core.prepared", "poulpy_tpu.ckks.layouts",
        "poulpy_tpu.ckks.plaintext", "poulpy_tpu.binfhe.lut",
    ):
        mod = importlib.import_module(modname)
        cls = getattr(mod, name, None)
        if cls is not None and dataclasses.is_dataclass(cls):
            return cls
    raise ValueError(f"unknown nested layout class {name!r}")


def deserialize_layout(data: bytes, cls):
    import json

    view = memoryview(data)
    mlen = _struct.unpack_from("<Q", view, 0)[0]
    hdr = json.loads(bytes(view[8 : 8 + mlen]))
    if hdr["type"] != cls.__name__:
        raise ValueError(f"type mismatch: {hdr['type']} != {cls.__name__}")
    off = 8 + mlen
    kwargs = {}
    nested_cls = {}
    for k, v in hdr["meta"].items():
        if isinstance(v, dict) and "__bytes__" in v:
            kwargs[k] = bytes.fromhex(v["__bytes__"])
        elif isinstance(v, dict) and "__none__" in v:
            kwargs[k] = None
        elif isinstance(v, dict) and "__nested__" in v:
            nested_cls[k] = _resolve_layout_class(v["__nested__"])
        else:
            kwargs[k] = v
    while off < len(data):
        nlen = _struct.unpack_from("<Q", view, off)[0]
        off += 8
        name = bytes(view[off : off + nlen]).decode()
        off += nlen
        if name in nested_cls:
            tag, blen = _struct.unpack_from("<QQ", view, off)
            if tag != _NESTED_TAG:
                raise ValueError("corrupt nested section")
            off += 16
            kwargs[name] = deserialize_layout(
                bytes(view[off : off + blen]), nested_cls[name]
            )
            off += blen
        else:
            arr, consumed = read_array(view[off:])
            off += consumed
            kwargs[name] = arr
    return cls(**kwargs)


def digest_u64(arr) -> int:
    """Content fingerprint (DigestU64, poulpy-hal/src/layouts/mod.rs:124):
    blake2b-8 over the raw little-endian bytes."""
    import hashlib

    data = np.asarray(arr).astype("<i8").tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
