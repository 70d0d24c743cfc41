"""Cost scopes: the port's counterpart of the reference's ``jax.named_scope``
tags (``attn_core``, ``moe_ffn``, ``ssd_core``), read by the cost counter
(``launch/hlo_analysis.CostMode``).

A function decorated with :func:`scoped` runs unchanged unless a counter
is active: the test of one module flag is all it adds to a call, so the
decode step's host time does not move.  Under a counter the scope holds
for every op the function executes and, in the backward pass, for every op
of an autograd node the function created: the function's region of the
forward's autograd sequence numbers is recorded, and an op that runs inside
a node of that region is the scope's (the reference's scope names reach its
transposed ops in the same way).  A rematerialized forward replayed inside
the backward runs under the scopes of its own calls and records no region.
"""
from __future__ import annotations

import functools

import torch

ACTIVE = False                                  # set by a counter while it runs
_stack: list[str] = []                          # scopes of the calls under way
_regions: list[tuple[int, int, str]] = []       # (first, end) sequence numbers, name


def reset() -> None:
    """Forget every scope and region (a counter calls this as it starts)."""
    _stack.clear()
    _regions.clear()


def current() -> str | None:
    """The innermost scope of the op about to run, or None."""
    if _stack:
        return _stack[-1]
    node = torch._C._current_autograd_node()
    if node is None or not _regions:
        return None
    seq = node._sequence_nr()
    inside = [(end - first, name) for first, end, name in _regions if first <= seq < end]
    return min(inside)[1] if inside else None      # the innermost region


def scoped(name: str):
    """Decorate a function so that the ops it runs, forward and backward,
    are charged to scope ``name`` while a counter is active."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            replay = torch._C._current_autograd_node() is not None
            first = torch._C._autograd._get_sequence_nr()
            _stack.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _stack.pop()
                if not replay:
                    _regions.append((first, torch._C._autograd._get_sequence_nr(), name))
        return wrapper
    return deco
