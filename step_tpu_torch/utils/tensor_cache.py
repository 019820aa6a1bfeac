"""Values derived from tensors, kept until the tensors change."""

from __future__ import annotations

import weakref

import torch


def derived(cache: dict, tensors, make, *extra):
    """`make()`, computed once and kept in `cache` (a dict its owner keeps,
    one per derived value) while each of `tensors` is the same tensor with
    the same storage and version counter, and `extra` is equal. An in-place
    write such as `load_state_dict` bumps the counter and `.to()` gives new
    storage, so either makes the value anew. Under `torch.export` (or
    `torch.compile`) the value is made in the traced program on every
    call: a cached tensor would enter the program as a constant and stand
    for weights that the program takes as an input."""
    if torch.compiler.is_compiling():
        return make()
    key = tuple((t.data_ptr(), t._version, t.device, t.dtype) for t in tensors) + extra
    if cache.get("key") == key and all(r() is t for r, t in zip(cache["refs"], tensors)):
        return cache["value"]
    value = make()
    cache.update(key=key, refs=tuple(weakref.ref(t) for t in tensors), value=value)
    return value
