"""What the kernel wrappers record of their calls for ``repro_torch.analysis``.

``kernel_node(name)`` decorates a wrapper.  While an observer is
registered (``observing``: ``analysis.contracts``'s dispatch mode), the
body of an outermost call runs with the dispatch modes switched off and
the observer is told of the call once, so the mode records it as one
opaque node and none of the PyTorch ops inside.  On the card the body's
ctypes launch never reaches the dispatcher; on the CPU the body runs the
plain version (``ref.py``), whose ops would otherwise count as the path's
own.  A wrapper called inside another (``sell_spmv_block`` runs
``sell_spmv``) is part of the outer node: a thread-local depth tells the
two apart.

Each outermost call also counts its operands' bytes
(``spans.count("kernels.bytes.<name>")``): every tensor argument once and
the result once (unless it is an argument, as the shard step's state is),
on the card and on the CPU alike.  For the trisolve and SpMV wrappers that
is the bytes of their bound (``analysis.traffic.trisolve_bytes``,
``spmv_bytes``), the measured side of ``analysis.traffic``'s kernel terms.
``kernels.operand_bytes`` reads them, and a replayed CUDA graph adds its
block's bytes as it adds its launches.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import _disable_current_modes

from ..spans import count


class _State(threading.local):
    depth = 0           # wrapper calls open on this thread
    observers = ()      # callbacks registered by ``observing``


_state = _State()


@contextlib.contextmanager
def observing(callback: Callable[[str, tuple, object], None]):
    """Call ``callback(name, args, result)`` after every outermost wrapper
    call of this thread while the block runs."""
    observers = _state.observers
    _state.observers = observers + (callback,)
    try:
        yield
    finally:
        _state.observers = observers


def kernel_node(name: str):
    """Decorator of the wrapper ``name``: its body is one opaque node, and
    its operand bytes count in ``kernels.bytes.<name>``."""
    key = f"kernels.bytes.{name}"

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            state = _state
            if state.depth:              # part of an outer wrapper's call
                return fn(*args, **kwargs)
            observers = state.observers
            state.depth = 1
            try:
                if observers:
                    # the observer's dispatch mode would skip every op of
                    # the body one at a time: run the body without it
                    with _disable_current_modes():
                        out = fn(*args, **kwargs)
                else:
                    out = fn(*args, **kwargs)
            finally:
                state.depth = 0
            n, has_out = 0, False
            for a in args:
                if isinstance(a, torch.Tensor):
                    n += a.nbytes
                    has_out = has_out or a is out
            if not has_out and isinstance(out, torch.Tensor):
                n += out.nbytes
            count(key, n)
            for callback in observers:
                callback(name, args, out)
            return out
        return wrapper
    return deco
