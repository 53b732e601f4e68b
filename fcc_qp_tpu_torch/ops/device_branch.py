"""Device-side control flow of the read-free (static) solve: the port's
counterpart of the JAX package's ``lax.cond`` and bounded
``lax.while_loop`` inside one compiled program.

`branch` is the one primitive every data-dependent skip of the static
reduced path goes through (`core.ds_engine._iterate_reduced`'s skipped
rounds and loop passes, the gathered loops of `ops.polish`, the hybrid
fallback, the Cholesky shift levels of `ops.ds_linalg`):
``branch(go, step, *carry)`` is ``step(*carry)`` where the 0-d device
flag ``go`` holds and ``carry`` unchanged where it does not. It has three
forms, one result:

* **under a CUDA graph capture**: an IF node of the graph (`if_node`,
  built from `csrc/graph_nodes.cu`, because PyTorch 2.11 exposes no
  conditional node). ``step`` is captured into the node's body, which
  writes the new carry IN PLACE into the carry's buffers; a replay runs
  or skips the body by ``go`` on the device, with no host read. A
  capture that cannot open the node raises: nothing falls back;
* **otherwise on a tensor flag** (the CPU, or the uncaptured static
  solve the captures are held against): ``step`` runs and each carried
  tensor is selected with ``torch.where(go, new, old)``;
* **on a Python bool** (the eager, reading solve): ``step`` runs or not.

`gathered_loop` is a capacity-gathered loop on top of it: the eager
solve loops while a pending mask has a set entry (a host read per
pass); the static one runs the loop's bound of guarded passes and
records in `exhausted_flag` whether work was still pending after the
last (a bound that is too small is a bug, and `chip_smoke.py` requires
the flag clear).

Rules for a ``step`` (they keep the three forms equal bit for bit):
it returns the new carry with the structure of the old (tensors,
dataclasses, tuples, lists, None) and the same shape and dtype per
tensor; where ``go`` is false it must compute nothing the rest of the
solve reads, and tensors it makes are read only through the carry (a
skipped body leaves them unwritten); a step may update a carried tensor
in place only where that update is the identity when ``go`` is false
(a masked gathered pass).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import pathlib
import weakref

import torch

_SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "graph_nodes.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# cudaStreamCaptureMode of a body's capture: global, as the graph's own
CAPTURE_MODE_GLOBAL = 0

_lib = None
# per device: the body streams (one per nesting depth, reused by every
# body at that depth, so that a body's temporaries reuse the blocks of
# the bodies before it) and the memory pool the bodies allocate from
_BODIES: dict = {}
# per device: the 0-d flag `gathered_loop` sets when a static loop ends
# with work pending
_EXHAUSTED: dict = {}
# the body graphs of the IF nodes opened so far, as ints (`cudaGraph_t`,
# owned by their graphs): `chip_smoke.py` clears the list before a
# capture and counts the nodes of each body after it
body_graphs: list = []


def build_graph_nodes() -> ctypes.CDLL:
    """Compile `csrc/graph_nodes.cu` (nvcc, once per content) and load
    it."""
    global _lib
    if _lib is not None:
        return _lib
    from fcc_qp_tpu_torch.ops.pallas_admm import build_library

    so, _, _ = build_library(_SOURCE, NVCC_FLAGS)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.if_node_begin.argtypes = [p, p, p, ctypes.c_int, ctypes.POINTER(p)]
    lib.if_node_end.argtypes = [p]
    lib.make_stream.argtypes = [ctypes.POINTER(p)]
    for fn in (lib.if_node_begin, lib.if_node_end, lib.make_stream):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def device_key(device) -> str:
    """``device`` named with its index (``cuda`` is the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def capturing(t: torch.Tensor) -> bool:
    """Whether work on ``t``'s device is being captured into a graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _bodies(dev: torch.device) -> dict:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    b = _BODIES.get(key)
    if b is None:
        b = _BODIES[key] = dict(streams=[], pool=torch.cuda.graph_pool_handle(),
                                depth=0, index=key)
    return b


def _body_stream(b: dict, dev: torch.device):
    while len(b["streams"]) <= b["depth"]:
        raw = ctypes.c_void_p()
        err = build_graph_nodes().make_stream(ctypes.byref(raw))
        if err != 0:
            raise RuntimeError(f"cudaStreamCreate failed: CUDA error {err}")
        b["streams"].append(torch.cuda.ExternalStream(raw.value, device=dev))
    return b["streams"][b["depth"]]


def _allocate_to_pool(b: dict, begin: bool) -> None:
    """Route this thread's allocations to the bodies' pool, or stop. The
    graph's own capture keeps its pool (its filter, matching its capture
    stream, comes first); the bodies' streams capture into other graphs,
    so their allocations would otherwise come from outside any graph."""
    if begin:
        torch._C._cuda_beginAllocateCurrentThreadToPool(b["index"], b["pool"])
    else:
        torch._C._cuda_endAllocateToPool(b["index"], b["pool"])


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the enclosed work into the body of an IF node that runs
    where the 0-d bool ``pred`` (a CUDA tensor) is set at replay time.
    The current stream must be capturing a graph; nests."""
    if pred.dtype != torch.bool or pred.dim() != 0 or not pred.is_cuda:
        raise TypeError("an IF node takes a 0-d bool CUDA tensor")
    dev = pred.device
    parent = torch.cuda.current_stream(dev)
    b = _bodies(dev)
    body = _body_stream(b, dev)
    graph = ctypes.c_void_p()
    err = build_graph_nodes().if_node_begin(
        parent.cuda_stream, pred.data_ptr(), body.cuda_stream,
        CAPTURE_MODE_GLOBAL, ctypes.byref(graph))
    if err != 0:
        raise RuntimeError(f"could not open an IF node: CUDA error {err}")
    body_graphs.append(graph.value)
    outer = b["depth"] == 0
    if outer:
        _allocate_to_pool(b, True)
    b["depth"] += 1
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        b["depth"] -= 1
        err = build_graph_nodes().if_node_end(body.cuda_stream)
        if outer:
            _allocate_to_pool(b, False)
        if err != 0:
            raise RuntimeError(f"could not close an IF node: CUDA error {err}")


# --------------------------------------------------------------------------
# the branch primitive
# --------------------------------------------------------------------------


def _leaves(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)
    elif isinstance(x, (tuple, list)):
        for a in x:
            _leaves(a, out)
    return out


def _rebuild(x, it):
    """``x`` with its tensor leaves taken in order from the iterator."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _rebuild(getattr(x, f.name), it)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        vals = [_rebuild(a, it) for a in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, list):
        return [_rebuild(a, it) for a in x]
    return x


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _check_pair(new: torch.Tensor, old: torch.Tensor) -> None:
    if new.shape != old.shape or new.dtype != old.dtype:
        raise ValueError(
            f"a branch step changed a carried tensor from {old.dtype} "
            f"{tuple(old.shape)} to {new.dtype} {tuple(new.shape)}")


def branch(go, step, *carry):
    """``step(*carry)`` where ``go`` holds, else ``carry`` (the module
    docstring). ``go``: a Python bool (decided on the host) or a 0-d bool
    tensor (decided on the device). Returns the carry as a tuple."""
    if isinstance(go, bool):
        return tuple(step(*carry)) if go else carry
    if not capturing(go):
        new = tuple(step(*carry))
        olds, news = _leaves(carry, []), _leaves(new, [])
        if len(olds) != len(news):
            raise ValueError("a branch step changed the carry's structure")
        picked = []
        for n, o in zip(news, olds):
            if n is not o:
                _check_pair(n, o)
                n = torch.where(go, n, o)
            picked.append(n)
        return _rebuild(carry, iter(picked))
    # under capture: every carried tensor gets a buffer of its own, which
    # the body updates in place (no other name may see the write)
    olds, seen = [], set()
    for o in _leaves(carry, []):
        if id(o) in seen or not _owned(o):
            o = o.clone()
            _OWNED[id(o)] = weakref.ref(o)
        seen.add(id(o))
        olds.append(o)
    carry = _rebuild(carry, iter(olds))
    with if_node(go):
        news = _leaves(tuple(step(*carry)), [])
        if len(olds) != len(news):
            raise ValueError("a branch step changed the carry's structure")
        stores = {_storage(o) for o in olds}
        pairs = []
        for n, o in zip(news, olds):
            if n is o:
                continue
            _check_pair(n, o)
            if _storage(n) in stores:
                # the new value reads a buffer this node also writes
                n = n.clone()
            pairs.append((n, o))
        for n, o in pairs:
            o.copy_(n)
    return carry


# the buffers `branch` made under a capture, by id (weakly: a freed
# tensor's id can be reused, so the reference must still lead to it)
_OWNED: dict = {}


def _owned(t: torch.Tensor) -> bool:
    r = _OWNED.get(id(t))
    return r is not None and r() is t


def forget_owned() -> None:
    """Drop the records of `branch`'s buffers (a capture's end: they are
    its graph's)."""
    _OWNED.clear()


# --------------------------------------------------------------------------
# gathered loops
# --------------------------------------------------------------------------


def exhausted_flag(device) -> torch.Tensor:
    """The 0-d bool flag a static `gathered_loop` on ``device`` sets when
    it reaches its bound with work pending. Made outside any capture (a
    graph updates it in place); clear it with ``.fill_(False)``."""
    dev = torch.device(device)
    key = device_key(dev)
    f = _EXHAUSTED.get(key)
    if f is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the exhausted flag must exist before a "
                               "capture")
        f = _EXHAUSTED[key] = torch.zeros((), dtype=torch.bool, device=dev)
    return f


def gathered_loop(static: bool, n: int, pending, step, *carry):
    """A capacity-gathered loop: ``carry = step(*carry)`` while
    ``pending(*carry)`` (a bool mask) has a set entry, read on the host;
    ``static``: ``n`` passes, each a `branch` on that flag, then
    `exhausted_flag` records whether work was still pending (``n`` is the
    loop's bound, so it never should). Returns the carry."""
    if not static:
        while bool(pending(*carry).any()):
            carry = tuple(step(*carry))
        return carry
    for _ in range(n):
        carry = branch(pending(*carry).any(), step, *carry)
    left = pending(*carry).any()
    exhausted_flag(left.device).logical_or_(left)
    return carry
