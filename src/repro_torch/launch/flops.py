"""Executed FLOPs, modeled HBM bytes and the peak of live bytes of a step,
counted while it runs.

Port of ``repro/launch/flops.py``. The reference traces a step into a
jaxpr and walks it, multiplying each ``scan`` body by its length, since
XLA's cost analysis counts a loop body once. The port has no compiler and
no trace: :func:`step_costs` runs the step, on ``device="meta"`` tensors
in the dry-run (shapes and dtypes, no data, nothing allocated), under
:class:`CostMode`, a ``TorchDispatchMode`` that sees every ATen operation
the step executes, the backward's and a checkpoint's recompute included.
Python executes the loops, so no trip count is needed: what is counted is
what runs, which is the reference's "executed FLOPs". Counting never
reads a value, so a CPU run and a meta run of a step count the same.

What is counted (integers, global over the step):

* ``flops``: 2·M·N·K of every ``mm`` / ``bmm`` / ``addmm`` /
  ``baddbmm`` (and 2 × output × kernel volume × input channels per group
  for ``convolution``), the reference's ``dot_general`` /
  ``conv_general_dilated``. Split by the product's dtype into
  ``flops_bf16`` (bf16 and fp16 operands: the tensor cores) and
  ``flops_fp32`` (every other dtype); ``flops`` is their sum.
* Einsum products with nothing to sum. ``jnp.einsum`` contracts a
  product pair by pair and lowers each pair to a ``dot_general``, also a
  pair with no summed index (an outer or broadcast product, K = 1), which
  the reference counts; ``torch.einsum`` lowers such a pair to ``mul``,
  which no product counter sees. :class:`CostMode` therefore also watches
  the port's ``models.layers.einsum`` (``watch_einsums``; a checkpoint's
  recompute re-enters the forward's watchers), takes the pairs in
  ``jnp.einsum``'s order (:func:`einsum_pairs`, the cheapest pair first,
  as ``opt_einsum``'s optimal path) and counts each K = 1 pair as the
  reference does: 2 × its output's elements, and in the backward the same
  again for each of its operands that gets a gradient (the transposed
  products). The SSD's three-operand einsums (``models.ssm._ssd``) and
  mamba's decode update are the port's cases.
* ``dot_bytes``: the operands and outputs of those products. An operand
  is counted at the fewest bytes it was held in along the views, copies
  and dtype conversions it came through (:meth:`CostMode.read_bytes`): a
  ``.float()`` widening of bf16 activations, or a broadcast that
  ``matmul`` expands (a stride-0 view, or its copy), is elementwise work
  that fuses into the product's read, as XLA fuses a convert or a
  broadcast into a ``dot_general``'s operand, so it is read at the
  narrow, unbroadcast bytes the reference's operand has.
* ``gather_bytes``: the outputs of ``index`` / ``index_select`` /
  ``gather`` / ``scatter*`` / ``index_put`` / ``index_add`` /
  ``embedding`` (the whole destination of an in-place scatter, as the
  reference's ``scatter`` output is).
* ``scan_io_bytes``: always 0. The reference counts each ``lax.scan``'s
  per-step slices and carries; the port has no scan. Its layer loop
  indexes the stacked parameters as views, and its attention and SSD
  loops index chunk views, none of which moves a byte by itself.
* ``hbm_bytes_model``: ``dot_bytes + gather_bytes + scan_io_bytes``, the
  reference's fusion-aware traffic model (elementwise chains fuse; what
  survives are the products' streams and the gathers). A model, not a
  measurement.

:class:`CostMode` also tracks the bytes of the storages the step creates
that are alive (each output storage counted once, released when its last
tensor dies) and their peak (``peak_bytes``), the arguments excluded.
With ``device="meta"`` it refuses any output that holds an element and
is not on meta (``torch.utils.checkpoint`` makes an empty CPU tensor of
its own), so a dry-run allocates no memory on any device.

On meta it also memoizes each functional operation's output shapes,
strides and dtypes by its inputs' (and its other arguments): many meta
kernels are Python references that take ~0.2 ms a call, and a long
sequence repeats the same few shapes thousands of times (a 32k prefill
runs 32 × 32 query × KV chunks a layer). An output is then a fresh
``empty_strided`` tensor with what the meta kernel gave the first time,
the same metadata, so the counts do not change.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.layers import einsum_watchers, watch_einsums

__all__ = ["CostMode", "count_flops", "count_hbm_bytes", "analyze",
           "step_costs", "einsum_pairs", "COST_KEYS"]

aten = torch.ops.aten

COST_KEYS = ("flops", "flops_bf16", "flops_fp32", "dot_bytes",
             "gather_bytes", "scan_io_bytes")

_MM = {aten.mm.default, aten.bmm.default, aten.addmm.default,
       aten.baddbmm.default}
_CONV = {aten.convolution.default}
_GATHER = ("index", "index_select", "gather", "scatter", "scatter_add",
           "scatter_reduce", "index_put", "_index_put_impl", "index_add",
           "embedding", "embedding_dense_backward")
_TENSOR_CORE = (torch.bfloat16, torch.float16)
# Elementwise copies: the output holds the input's elements (a dtype
# conversion, a materialized view). ``_unsafe_view`` is a view in all but
# its schema.
_COPIES = {aten._to_copy.default, aten.clone.default, aten.copy.default,
           aten.lift_fresh_copy.default}
_VIEWS_BY_NAME = {aten._unsafe_view.default}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


_FUNCTIONAL: dict = {}
_ROLE: dict = {}


def _role(func):
    """What :class:`CostMode` does with ``func``'s outputs: ``"mm"`` /
    ``"conv"`` (a product), ``"gather"``, ``"view"`` / ``"copy"`` (carry
    the input's read bytes), or ``None``."""
    role = _ROLE.get(func, 0)
    if role == 0:
        role = ("mm" if func in _MM else "conv" if func in _CONV else
                "gather" if _is_gather(func) else
                "copy" if func in _COPIES else
                "view" if func.is_view or func in _VIEWS_BY_NAME else None)
        _ROLE[func] = role
    return role


def _functional(func) -> bool:
    """Does ``func`` return fresh tensors only (no view, no in-place
    write), so that its outputs follow from its inputs' metadata?"""
    ok = _FUNCTIONAL.get(func)
    if ok is None:
        schema = func._schema
        ok = (not schema.is_mutable and bool(schema.returns)
              and all(r.alias_info is None
                      and str(r.type) in ("Tensor", "Tensor[]")
                      for r in schema.returns))
        _FUNCTIONAL[func] = ok
    return ok


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class _Meta(tuple):
    """The metadata of a tensor: ``(shape, stride, dtype)``."""


def _describe(x):
    if isinstance(x, torch.Tensor):
        return _Meta((x.shape, x.stride(), x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple([_describe(v) for v in x])
    if isinstance(x, dict):
        return tuple([(k, _describe(v)) for k, v in sorted(x.items())])
    return x


def _build(made):
    if isinstance(made, _Meta):
        shape, stride, dtype = made
        return torch.empty_strided(shape, stride, dtype=dtype,
                                   device="meta")
    return type(made)(_build(m) for m in made) if isinstance(made, tuple) \
        else made


def _distinct(t) -> int:
    """Elements of ``t`` in memory: a stride-0 (broadcast) dimension
    holds one."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)


def _is_gather(func) -> bool:
    return func.overloadpacket.__name__.rstrip("_") in _GATHER


def einsum_pairs(equation: str, shapes) -> list[dict]:
    """The pairwise products ``jnp.einsum`` lowers ``equation`` on operands
    of ``shapes`` to, in its order: for three operands the pair whose two
    steps cost least first (``opt_einsum``'s optimal path and its cost
    measure), for two the one pair. Ties, which the SSD's einsums meet
    where the state and head widths are equal, go as ``opt_einsum`` broke
    them there: to a first pair that sums an index, then to the later
    pair. Each entry: ``lhs`` / ``rhs`` (operand positions, or ``"t"``
    for the previous pair's result), their index strings ``a`` / ``b``,
    the result's indices ``out``, and ``k``, the product of the summed
    sizes (1: nothing summed)."""
    lhs_s, _, out_s = equation.replace(" ", "").partition("->")
    terms = lhs_s.split(",")
    if len(terms) != len(shapes):
        raise ValueError(f"einsum {equation!r}: {len(shapes)} operands")
    size = {}
    for t, s in zip(terms, shapes):
        size.update(zip(t, s))
    if len(terms) == 1:
        return []

    def step(a, b, keep):
        both = set(a) | set(b)
        out = "".join(c for c in a + b if c in keep and c in both)
        out = "".join(dict.fromkeys(out))
        summed = [c for c in set(a) & set(b) if c not in keep]
        return out, math.prod(size[c] for c in summed)

    def cost(a, b, out):
        idx = set(a) | set(b)
        inner = any(c not in out for c in idx)
        return math.prod(size[c] for c in idx) * (2 if inner else 1)

    if len(terms) == 2:
        a, b = terms
        out, k = step(a, b, set(out_s))
        return [dict(lhs=0, rhs=1, a=a, b=b, out=out, k=k)]
    if len(terms) != 3:
        raise ValueError(f"einsum {equation!r}: the counter takes two or "
                         "three operands")
    best = None
    for i, j in ((0, 1), (0, 2), (1, 2)):
        r = 3 - i - j
        keep = set(out_s) | set(terms[r])
        mid, k1 = step(terms[i], terms[j], keep)
        last, k2 = step(mid, terms[r], set(out_s))
        c = cost(terms[i], terms[j], mid) + cost(mid, terms[r], last)
        rank = (c, k1 == 1, -i, -j)
        if best is None or rank < best[0]:
            best = (rank, [dict(lhs=i, rhs=j, a=terms[i], b=terms[j],
                                out=mid, k=k1),
                           dict(lhs="t", rhs=r, a=mid, b=terms[r],
                                out=last, k=k2)])
    return best[1]


class CostMode(TorchDispatchMode):
    """Counts the work of the ATen operations run inside it (module
    docstring). ``costs()`` gives the counts; ``peak_bytes`` the most
    bytes of storages created inside it alive at once. ``device`` (e.g.
    ``"meta"``): every tensor an operation outputs must be on it."""

    def __init__(self, device=None):
        super().__init__()
        self.counts = dict.fromkeys(COST_KEYS, 0)
        self.device = None if device is None else torch.device(device)
        self._memo = {} if self.device == torch.device("meta") else None
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._read: dict[int, tuple[int, int]] = {}

    def __enter__(self):
        self._watching = watch_einsums(einsum_watchers() + (self._einsum,))
        self._watching.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._watching.__exit__(*exc)

    def costs(self) -> dict:
        out = dict(self.counts)
        out["hbm_bytes_model"] = (out["dot_bytes"] + out["gather_bytes"]
                                  + out["scan_io_bytes"])
        return out

    # -- operand bytes --------------------------------------------------
    def read_bytes(self, t) -> int:
        """The bytes a product reads for operand ``t``: its distinct
        elements at its itemsize, or fewer where it is a view, a copy or a
        dtype conversion of a tensor held in fewer bytes (module
        docstring)."""
        n = _distinct(t)
        own = n * t.element_size()
        src = self._read.get(id(t))
        return own if src is None else min(own, src[0] * n // src[1])

    def _derive(self, kind, args, outs) -> None:
        """Carry the read bytes of ``args[0]`` to the outputs of a view
        (same bytes per distinct element) or an elementwise copy (the
        input's read bytes, over the output's distinct elements)."""
        src = args[0] if args and isinstance(args[0], torch.Tensor) \
            else None
        if src is None:
            return
        n_in = _distinct(src)
        if not n_in:
            return
        read = self.read_bytes(src)
        for t in outs:
            n = _distinct(t)
            pair = (read, n_in) if kind == "view" else (read, n)
            if pair[0] * n < n * t.element_size() * pair[1]:
                key = id(t)
                if key not in self._read:
                    weakref.finalize(t, self._read.pop, key, None)
                self._read[key] = pair

    # -- products -------------------------------------------------------
    def _product(self, flops: int, dtype, nbytes: int) -> None:
        key = "flops_bf16" if dtype in _TENSOR_CORE else "flops_fp32"
        self.counts[key] += flops
        self.counts["flops"] += flops
        self.counts["dot_bytes"] += nbytes

    def _einsum(self, equation, operands, out) -> None:
        shapes = [tuple(t.shape) for t in operands]
        pairs = einsum_pairs(equation, shapes)
        read = {i: self.read_bytes(t) for i, t in enumerate(operands)}
        grad = {i: t.requires_grad for i, t in enumerate(operands)}
        isz = out.element_size()
        sizes = {}
        for term, s in zip(equation.replace(" ", "").split("->")[0]
                           .split(","), shapes):
            sizes.update(zip(term, s))
        backward = []
        for p in pairs:
            if p["k"] != 1:
                continue       # a sum: torch runs it as a bmm, seen below
            n_out = math.prod(sizes[c] for c in p["out"])
            a = (math.prod(sizes[c] for c in p["a"]) * isz
                 if p["lhs"] == "t" else read[p["lhs"]])
            b = read[p["rhs"]]
            self._product(2 * n_out, out.dtype, a + b + n_out * isz)
            # The transposed products: d(lhs) = g . rhs, d(rhs) = g . lhs,
            # each reading the cotangent and the other operand.
            if p["lhs"] == "t" or grad[p["lhs"]]:
                backward.append((2 * n_out, n_out * isz + b + a))
            if grad[p["rhs"]]:
                backward.append((2 * n_out, n_out * isz + a + b))
        if backward and out.requires_grad:
            dtype = out.dtype

            def on_grad(g):
                for flops, nbytes in backward:
                    self._product(flops, dtype, nbytes)

            out.register_hook(on_grad)

    # -- dispatch -------------------------------------------------------
    def _run(self, func, args, kwargs):
        if self._memo is None or not _functional(func):
            return func(*args, **kwargs)
        try:
            key = (func, _describe(args), _describe(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        made = self._memo.get(key)
        if made is None:
            out = func(*args, **kwargs)
            # An output sharing an input's storage (``_unsafe_view``, an
            # op that hands back its input) is run every time.
            ins = {t.untyped_storage()._cdata for t in _tensors(args)}
            fresh = all(t.untyped_storage()._cdata not in ins
                        for t in _tensors(out))
            self._memo[key] = _describe(out) if fresh else False
            return out
        if made is False:
            return func(*args, **kwargs)
        return _build(made)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if isinstance(out, torch.Tensor):
            outs = (out,)
        elif isinstance(out, (tuple, list)):
            outs = [t for t in out if isinstance(t, torch.Tensor)]
        else:
            outs = ()
        if self.device is not None:
            for t in outs:
                if t.device != self.device and t.numel():
                    raise RuntimeError(
                        f"{func}: an output of {_nbytes(t)} B on "
                        f"{t.device}, not {self.device}: a counting run "
                        "allocates nothing")
        role = _role(func)
        if role == "mm":
            a, b = args[-2], args[-1]
            if func in (aten.addmm.default, aten.baddbmm.default):
                a, b = args[1], args[2]
            self._product(2 * out.numel() * a.shape[-1], a.dtype,
                          self.read_bytes(a) + self.read_bytes(b)
                          + _nbytes(out))
        elif role == "conv":
            x, w = args[0], args[1]
            groups = args[8] if len(args) > 8 else kwargs.get("groups", 1)
            per_out = math.prod(w.shape[2:]) * (x.shape[1] // groups)
            self._product(2 * out.numel() * per_out, x.dtype,
                          self.read_bytes(x) + self.read_bytes(w)
                          + _nbytes(out))
        elif role == "gather":
            self.counts["gather_bytes"] += sum(_nbytes(t) for t in outs)
        elif role is not None:
            self._derive(role, args, outs)
        for t in outs:
            self._track(t)
        return out

    def exclude(self, tree) -> None:
        """Leave the storages of the tensors in ``tree`` (the arguments)
        out of the live bytes, also where the step takes views of them."""
        if isinstance(tree, torch.Tensor):
            st = tree.untyped_storage()
            self._live.setdefault(id(st), 0)
            weakref.finalize(st, self._live.pop, id(st), None)
        elif isinstance(tree, dict):
            for v in tree.values():
                self.exclude(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                self.exclude(v)

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)


def analyze(fn, *args, device=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostMode` and return its
    counts (``COST_KEYS`` and ``hbm_bytes_model``) and ``peak_bytes``; the
    counterpart of ``analyze_jaxpr`` on the step's trace."""
    mode = CostMode(device)
    mode.exclude((args, kwargs))
    with mode:
        fn(*args, **kwargs)
    out = mode.costs()
    out["peak_bytes"] = mode.peak_bytes
    return out


def count_flops(fn, *args, **kwargs) -> int:
    return analyze(fn, *args, **kwargs)["flops"]


def count_hbm_bytes(fn, *args, **kwargs) -> int:
    return analyze(fn, *args, **kwargs)["hbm_bytes_model"]


def _meta(x):
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_meta(v) for v in x)
    if hasattr(x, "meta") and hasattr(x, "shape") and hasattr(x, "dtype"):
        return x.meta()
    return x


def step_costs(fn, *abstract_args) -> dict:
    """Run ``fn`` on ``abstract_args`` (trees whose
    ``models.params.ShapeDtypeStruct`` leaves become meta tensors; other
    leaves pass as they are) under a meta :class:`CostMode`: the global
    counts of one step and ``peak_bytes``."""
    return analyze(fn, *_meta(abstract_args), device="meta")
