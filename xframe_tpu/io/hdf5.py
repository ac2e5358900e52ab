"""Recursive dict ↔ HDF5 group IO.

Keeps the reference's on-disk conventions (hdf5_plugin.py:29-156) so files are
interchangeable: dicts are groups; lists/tuples are groups tagged
`type=list|tuple` with stringified-index children; strings are utf-8 datasets
tagged `type=str`; bool/complex/float arrays are plain datasets. Adds an
explicit `type=none` marker (the reference cannot round-trip None).
"""
from __future__ import annotations

import numpy as np


def save(path, data: dict):
    import h5py  # lazy: the phasing path imports the package without HDF5
    with h5py.File(path, "w") as f:
        _save_group(f, data)


def load(path) -> dict:
    import h5py
    with h5py.File(path, "r") as f:
        return _load_group(f)


def _save_group(group, data: dict):
    for key, item in data.items():
        _save_item(group, str(key), item)


def _save_item(group, key, item):
    if item is None:
        d = group.create_dataset(key, data=np.uint8(0))
        d.attrs["type"] = "none"
    elif isinstance(item, str):
        d = group.create_dataset(key, data=item.encode("utf-8"))
        d.attrs["type"] = "str"
    elif isinstance(item, (bool, int, float, complex, bytes, np.number, np.bool_)):
        group.create_dataset(key, data=item)
    elif isinstance(item, np.ndarray):
        if item.dtype == object:
            # ragged object arrays (e.g. per-l V_l) → list encoding
            _save_item(group, key, list(item))
        elif item.dtype.kind == "U":
            group.create_dataset(key, data=item.astype("S"))
        else:
            group.create_dataset(key, data=item)
    elif isinstance(item, (list, tuple)):
        sub = group.create_group(key)
        sub.attrs["type"] = "list" if isinstance(item, list) else "tuple"
        for i, elem in enumerate(item):
            _save_item(sub, str(i), elem)
    elif isinstance(item, dict):
        sub = group.create_group(key)
        _save_group(sub, item)
    elif hasattr(item, "__array__"):  # jax arrays and friends
        _save_item(group, key, np.asarray(item))
    elif hasattr(item, "dict"):  # DictNamespace
        _save_item(group, key, item.dict())
    else:
        raise TypeError(f"cannot save type {type(item)!r} at key {key!r}")


def _load_group(group) -> dict:
    out = {}
    for key, item in group.items():
        out[key] = _load_item(item)
    return out


def _load_item(item):
    import h5py
    tag = item.attrs.get("type", None)
    if isinstance(item, h5py.Dataset):
        if tag == "none":
            return None
        if tag == "str":
            raw = item[()]
            return raw.decode("utf-8") if isinstance(raw, bytes) else str(raw)
        value = item[()]
        if isinstance(value, bytes):
            return value.decode("utf-8")
        return value
    # group
    if tag in ("list", "tuple"):
        n = len(item)
        seq = [_load_item(item[str(i)]) for i in range(n)]
        return seq if tag == "list" else tuple(seq)
    return _load_group(item)
