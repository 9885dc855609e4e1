"""Cost of a fake-tensor trace: the port's counterpart of the JAX package's
``launch/hlo_cost.py``.

There is no HLO here.  The JAX package lowers each step with XLA and
parses the optimized HLO text; the port runs the eager step itself on
fake tensors (``FakeTensorMode``: shapes, dtypes and devices, no storage
and no values) under a ``TorchDispatchMode`` that sees every aten op the
step issues, and records:

  * FLOPs: ``torch.utils.flop_counter``'s formula for each op it knows
    (matmuls, convolutions, fused attention); every other op counts 0,
    as the reference counts only ``dot`` ops.
  * HBM bytes: the reference's first-order model -- operand + output
    bytes of each compute op (a broadcast operand read once).  Views (every op whose output aliases its
    input: ``view``, ``t``, ``expand``, ``as_strided``, ``detach``,
    ``slice``, ``select``, ...), ``empty*`` and metadata queries (no
    tensor out, e.g. ``prim::device``) count nothing; a copy or
    dtype conversion counts its read and its write (``copy_`` does not
    read its destination, ``fill_``/``zero_`` only write it).
  * Peak live bytes: the bytes of the distinct untyped storages alive at
    once (the inputs' among them), each rounded up to the CUDA caching
    allocator's 512-byte block and dropped through a weakref finalizer
    when its last tensor goes.  Python frees a tensor when its last
    reference goes, so this is the allocator's ``memory_allocated`` view
    without the cache.

The port's Python loops (blocks, microbatches, KV blocks) run every trip,
so no trip-count pass is needed, but a full trace of a deep stack at a
production shape takes minutes.  What the reference does with trip
counts the dry run does with depth (``extrapolate``): a stack traced at
one, two (and three) repeating units of blocks, every additive quantity
carried to the full depth.

The trace is global (one process, no partitioner): ``analyze`` divides it
over the devices of a mesh and attaches the collective model of
``hlo_analysis``.  Tracing touches no device: every input becomes a fake
CPU tensor, so each kernel wrapper on the path takes its plain version
(``kernels/__init__.py``) and no fake CUDA tensor reaches a kernel.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import torch

ALLOC_BLOCK = 512          # the CUDA caching allocator's size granularity

# a view whose schema does not say so, ops that allocate without touching
# memory, and the in-place ops that write their first operand without
# reading it
_NO_TRAFFIC = {"_unsafe_view", "empty", "empty_strided", "empty_like",
               "new_empty", "new_empty_strided", "lift_fresh",
               "lift_fresh_copy", "_local_scalar_dense"}
_WRITE_ONLY = {"fill_", "zero_", "copy_"}
def _alloc(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of operand ``t``: a broadcast dim (stride 0) is
    read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    """The tensors of a tree of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@dataclass
class Traced:
    """What one trace (or a depth extrapolation of traces) counted.  Every
    field but ``seconds`` and ``how`` is additive over the
    blocks of a stack."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    peak_bytes: int = 0        # live storages at their peak, inputs included
    arg_bytes: int = 0         # the inputs' storages
    out_bytes: int = 0         # the outputs' storages
    alias_bytes: int = 0       # outputs whose storage is an input's
    n_ops: int = 0
    kernels: Dict[str, dict] = field(default_factory=dict)
    by_op: Dict[str, list] = field(default_factory=dict)   # [n, flops, bytes]
    seconds: float = 0.0
    how: str = "full trace"

    @property
    def temp_bytes(self) -> int:
        """Peak live bytes beyond the inputs and the new outputs (the
        reference's ``temp_size_in_bytes``)."""
        return self.peak_bytes - self.arg_bytes - self.out_bytes + \
            self.alias_bytes

    def combine(self, other: "Traced", a: float, b: float) -> "Traced":
        """``a * self + b * other`` over every additive field."""
        def mix(x, y):
            return a * x + b * y

        def mixd(x, y, f):
            return {k: f(x.get(k), y.get(k)) for k in set(x) | set(y)}

        def kernel(x, y):
            x, y = x or {}, y or {}
            return {k: mix(x.get(k, 0), y.get(k, 0)) for k in set(x) | set(y)}

        def op(x, y):
            x, y = x or [0, 0, 0], y or [0, 0, 0]
            return [mix(u, v) for u, v in zip(x, y)]
        ints = {f: int(round(mix(getattr(self, f), getattr(other, f))))
                for f in ("peak_bytes", "arg_bytes", "out_bytes",
                          "alias_bytes", "n_ops")}
        return Traced(flops=mix(self.flops, other.flops),
                      hbm_bytes=mix(self.hbm_bytes, other.hbm_bytes),
                      kernels=mixd(self.kernels, other.kernels, kernel),
                      by_op=mixd(self.by_op, other.by_op, op),
                      seconds=self.seconds + other.seconds, **ints)


def extrapolate(points: Dict[int, Traced], units: int,
                rem: Optional[Traced] = None) -> Traced:
    """A stack of ``units`` repeating units from traces at 1, 2 (and 3)
    units (``points``: units -> trace).  Newton's forward differences carry
    every additive quantity to ``units``, exactly where it is a polynomial
    of degree ``len(points) - 1`` in the depth: a step that differentiates
    needs three points, since autograd's ``select_backward`` materialises
    the whole gradient of a stacked leaf at each block's use, so its bytes
    grow with the square of the depth.  The peak is carried linearly from
    the last two points.  ``rem``: the trace at one unit plus the trailing
    blocks, whose excess over ``points[1]`` is added."""
    ks = sorted(points)
    c = [points[k] for k in ks]
    if ks != list(range(1, len(ks) + 1)) or len(ks) < 2:
        raise ValueError(f"traces at 1, 2 (and 3) units needed, got {ks}")
    n = units - 1
    d1 = c[1].combine(c[0], 1, -1)
    out = c[0].combine(d1, 1, n)
    if len(c) > 2:
        d2 = c[2].combine(c[1], 1, -1).combine(d1, 1, -1)
        out = out.combine(d2, 1, n * (n - 1) / 2)
    a, b = c[-2], c[-1]
    out.peak_bytes = b.peak_bytes + (units - ks[-1]) * (b.peak_bytes
                                                        - a.peak_bytes)
    if rem is not None:
        out = out.combine(rem, 1, 1).combine(c[0], 1, -1)
    out.seconds = sum(t.seconds for t in c) + (rem.seconds if rem else 0.0)
    out.how = (f"extrapolated: {units} units from traces at "
               f"{', '.join(map(str, ks))}"
               + (" and one unit with the trailing blocks" if rem else ""))
    return out


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts flops, bytes and live storages of every aten op it sees."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.t = Traced()
        self.live: Dict[int, int] = {}
        self.cur = 0
        self.inside: List[str] = []     # kernel calls being run
        self.by_op = defaultdict(lambda: [0, 0.0, 0.0])

    def _free(self, key: int) -> None:
        n = self.live.pop(key, 0)
        self.cur -= n

    def see(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live from now until its last tensor goes."""
        s = t.untyped_storage()
        key = s._cdata
        if key in self.live:
            return
        n = _alloc(s.nbytes())
        self.live[key] = n
        self.cur += n
        if self.cur > self.t.peak_bytes:
            self.t.peak_bytes = self.cur
        weakref.finalize(s, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        packet = func._overloadpacket
        flops = 0.0
        if packet in self.flop_registry:
            flops = float(self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
        nbytes = 0.0
        outs = list(_tensors(out))
        if self.inside:                 # a kernel's plain version: see wrap
            k = self.t.kernels[self.inside[-1]]
            k["flops"] += flops
            k["n_ops"] += 1
        elif outs and not func.is_view and name not in _NO_TRAFFIC:
            ins = list(_tensors((args, kwargs)))
            if name in _WRITE_ONLY:
                ins = ins[1:]            # the destination is not read
            nbytes = float(sum(_read_bytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        if not self.inside:
            for t in outs:
                self.see(t)
        self.count(name, flops, nbytes)
        return out

    def count(self, name: str, flops: float, nbytes: float) -> None:
        self.t.n_ops += 1
        self.t.flops += flops
        self.t.hbm_bytes += nbytes
        rec = self.by_op[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    @contextlib.contextmanager
    def kernel_patches(self, kernels):
        """Wrap each ``(module, attribute)`` of ``kernels`` (name -> pair), a
        kernel wrapper, so that a call counts as the one launch it is on a
        card: its tensor inputs read once and its outputs written once, no
        temporaries.  The ops of the plain version it runs here add their
        flops, and nothing else."""
        saved = []

        def wrap(name, fn):
            def inner(*a, **kw):
                k = self.t.kernels.setdefault(
                    name, {"calls": 0, "flops": 0.0, "hbm_bytes": 0.0,
                           "n_ops": 0})
                k["calls"] += 1
                self.inside.append(name)
                try:
                    out = fn(*a, **kw)
                finally:
                    self.inside.pop()
                nbytes = float(sum(_read_bytes(t)
                                   for t in _tensors((a, kw)))
                               + sum(_nbytes(t) for t in _tensors(out)))
                k["hbm_bytes"] += nbytes
                for t in _tensors(out):
                    self.see(t)
                self.count(f"kernel {name}", 0.0, nbytes)
                return out
            return inner
        try:
            for name, (mod, attr) in (kernels or {}).items():
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))
                setattr(mod, attr, wrap(name, fn))
            yield
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)


def _fake_inputs(tree, mode):
    """``tree`` with every tensor (real, meta, or an ``Abstract`` leaf's) as
    a fresh contiguous fake CPU tensor of its shape and dtype; other
    leaves unchanged.  Tensors that share a storage stay sharing one."""
    made: Dict[int, torch.Tensor] = {}

    def conv(x):
        if hasattr(x, "tensor") and hasattr(x, "sharding"):   # an Abstract
            x = x.tensor
        if isinstance(x, torch.Tensor):
            key = id(x)
            if key not in made:
                with mode:
                    made[key] = torch.empty(tuple(x.shape), dtype=x.dtype,
                                            device="cpu")
            return made[key]
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x
    return conv(tree)


def trace(fn, *args, kernels=None, fake=True, **kw) -> Traced:
    """Run ``fn(*args, **kw)`` on fake CPU tensors of its inputs' shapes and
    count it (see the module docstring).  ``kernels``: name -> (module,
    attribute) of the kernel wrappers on the path, each call counted as
    one launch (``_Recorder.kernel_patches``) and on its own under
    ``Traced.kernels``.  ``fake=False`` runs ``fn`` on the inputs as they
    are (real tensors, on their device), so the same count is taken of a
    real run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    if fake:
        args, kw = _fake_inputs((args, kw), mode)
    rec = _Recorder()
    for t in _tensors((args, kw)):
        rec.see(t)
    rec.t.arg_bytes = rec.cur
    ins = {t.untyped_storage()._cdata for t in _tensors((args, kw))}
    t0 = time.perf_counter()
    with rec.kernel_patches(kernels), mode, rec:
        out = fn(*args, **kw)
    rec.t.seconds = time.perf_counter() - t0
    seen = set()
    for t in _tensors(out):
        s = t.untyped_storage()
        if s._cdata in seen:
            continue
        seen.add(s._cdata)
        n = _alloc(s.nbytes())
        rec.t.out_bytes += n
        if s._cdata in ins:
            rec.t.alias_bytes += n
    rec.t.by_op = {k: list(v) for k, v in rec.by_op.items()}
    res = rec.t
    del out, args, kw
    return res


def top_ops(traced: Traced, n: int = 12, key: int = 2) -> dict:
    """The ``n`` ops that moved the most bytes (``key`` 2) or did the most
    flops (``key`` 1): name -> [calls, flops, bytes]."""
    ranked = sorted(traced.by_op.items(), key=lambda kv: -kv[1][key])
    return {k: v for k, v in ranked[:n] if v[key]}


def analyze(traced: Traced, n_devices: int = 1, collectives=None) -> dict:
    """The reference's keys, per device: the trace's flops and bytes divided
    over ``n_devices`` (the record names this model), and the collective
    model's wire bytes (``hlo_analysis.CollectiveStats``, already per
    device)."""
    per_op = collectives.per_op if collectives is not None else []
    return {
        "flops": traced.flops / n_devices,
        "hbm_bytes": traced.hbm_bytes / n_devices,
        "coll_wire_bytes": collectives.wire_bytes if per_op else 0.0,
        "coll_by_kind": collectives.by_kind() if per_op else {},
        "n_collectives": float(sum(o["count"] for o in per_op)),
        "warnings": [],
        "per_device": "global trace / devices" if n_devices > 1
        else "global trace (one device)",
        "counted": traced.how,
    }
