"""ONNX export: a torch.export program lowered to a standard .onnx graph
(port of gpt_sovits_tpu/utils/onnx_export.py).

The JAX package traces a jaxpr and lowers each primitive; here the function
is exported with torch.export (utils/export.py, fixed shapes), decomposed to
core ATen (`run_decompositions`, replicate padding kept whole), and each node of the FX graph is lowered
through one flat table keyed by the ATen overload (`_OPS`). Parameters,
buffers and lifted constants become initializers; a node whose inputs are
all known at export time (`arange`, `full`, shape arithmetic, a transposed
weight) is evaluated then and becomes a constant, so shape-only subgraphs
fold at the fixed shapes. The graph is serialized with utils/onnx_lite.py's
writer (opset 17), in float32: bfloat16 initializers are widened and casts
to bfloat16 become casts to float32, as in the JAX package.

The graphs mean the same under the ONNX specification and under
utils/onnx_lite.py's executor, which floors integer `Div` and gives `Mod`
its `fmod` attribute's meaning: no integer `Div` is emitted (floor and
truncating divisions go through float32), float remainders are built from
Floor, and `torch.fmod` is `Mod` with fmod=1.

Scope, as in the JAX package and the reference's onnx_export.py: the S1
prefill and KV-cached decode step, S2 `decode` for v1/v2/v2Pro/v2ProPlus,
and the vocoders. The v3/v4 CFM path stays a pt2 export (utils/export.py).
An ATen op outside the table raises NotImplementedError naming it.
"""

from __future__ import annotations

import operator

import numpy as np
import torch
import torch.nn as nn

from gpt_sovits_tpu_torch.utils.export import (
    _Call, _s2_args, export_program, plain_vocoder, s1_step_args, s1_step_module, s2_decode_module, subset,
    vocoder_args,
)
from gpt_sovits_tpu_torch.utils.onnx_lite import Graph, Node, encode_model

aten = torch.ops.aten

# ONNX TensorProto element types; bfloat16 is exported as float32
_ONNX_TYPE = {torch.float32: 1, torch.bfloat16: 1, torch.uint8: 2, torch.int8: 3, torch.int16: 5, torch.int32: 6,
              torch.int64: 7, torch.bool: 9, torch.float16: 10, torch.float64: 11}
_NP_TYPE = {torch.float32: np.float32, torch.bfloat16: np.float32, torch.uint8: np.uint8, torch.int8: np.int8,
            torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
            torch.float16: np.float16, torch.float64: np.float64}
_SKIP = {aten._assert_tensor_metadata.default, aten._assert_scalar.default, aten.sym_constrain_range_for_size.default}
_SMALL = 1024  # constants up to this many bytes are shared by value, larger ones by identity


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _meta(node):
    return node.meta["val"]


class _Converter:
    def __init__(self, name: str):
        self.g = Graph(name=name)
        self._n = 0
        self._consts: dict = {}  # (bytes, dtype, shape) or ("id", id) -> initializer name
        self._keep: list = []  # tensors whose id keys the cache
        self.dtype: dict = {}  # ONNX tensor name -> torch dtype (bfloat16 as float32)

    # -- naming / graph helpers ---------------------------------------------

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, value, dtype: torch.dtype | None = None, hint: str = "c") -> str:
        """An initializer for a folded tensor or a Python value (in `dtype`
        where given)."""
        if isinstance(value, torch.Tensor):
            t = value if dtype is None else value.to(dtype)
            if t.numel() * t.element_size() > _SMALL and dtype is None:
                key = ("id", id(value))
                self._keep.append(value)
            else:
                key = None
            arr = _np(t)
            dt = _wide(t.dtype)
        else:
            dt = _wide(dtype) if dtype is not None else (torch.float32 if isinstance(value, float) else
                                                         torch.bool if isinstance(value, bool) else torch.int64)
            arr = np.asarray(value, dtype=_NP_TYPE[dt])
            key = None
        if key is None:
            key = (arr.tobytes(), str(arr.dtype), arr.shape)
        if key not in self._consts:
            name = self.fresh(hint)
            self.g.initializers[name] = np.array(arr, order="C")  # ascontiguousarray would make a 0-d array 1-d
            self.dtype[name] = dt
            self._consts[key] = name
        return self._consts[key]

    def node(self, op: str, inputs: list, n_out: int = 1, dtype: torch.dtype | None = None, **attrs) -> list:
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.g.nodes.append(Node(op, list(inputs), outs, attrs, name=outs[0]))
        if dtype is not None:
            for o in outs:
                self.dtype[o] = _wide(dtype)
        return outs

    def n1(self, op: str, inputs: list, dtype: torch.dtype | None = None, **attrs) -> str:
        return self.node(op, inputs, 1, dtype, **attrs)[0]

    def i64(self, values) -> str:
        return self.const(np.asarray(values, np.int64).tolist(), torch.int64, "shape")

    def as_type(self, v, dtype: torch.dtype) -> str:
        """`v` (an ONNX name, a folded tensor or a Python number) as an ONNX
        tensor of `dtype`, cast where it differs."""
        dtype = _wide(dtype)
        if isinstance(v, str):
            return v if self.dtype[v] == dtype else self.n1("Cast", [v], dtype, to=_ONNX_TYPE[dtype])
        if isinstance(v, torch.Tensor):
            return self.const(v if _wide(v.dtype) == dtype else v.to(dtype))
        return self.const(v, dtype)

    def reshape(self, x: str, shape) -> str:
        shape = [int(s) for s in shape]
        attrs = {"allowzero": 1} if 0 in shape else {}
        return self.n1("Reshape", [x, self.i64(shape)], self.dtype[x], **attrs)

    def transpose(self, x: str, perm) -> str:
        perm = [int(p) for p in perm]
        if perm == list(range(len(perm))):
            return x
        return self.n1("Transpose", [x], self.dtype[x], perm=perm)

    def static_slice(self, x: str, starts, ends, axes, steps=None) -> str:
        steps = steps if steps is not None else [1] * len(starts)
        return self.n1("Slice", [x, self.i64(starts), self.i64(ends), self.i64(axes), self.i64(steps)], self.dtype[x])

    def flip(self, x: str, dims, shape) -> str:
        dims = [int(d) % len(shape) for d in dims]
        return self.static_slice(x, [-1] * len(dims), [-(int(shape[d]) + 1) for d in dims], dims, [-1] * len(dims))


# ---------------------------------------------------------------------------
# the ATen table: each entry (converter, node, args, kwargs) -> ONNX name(s)
# ---------------------------------------------------------------------------

_OPS: dict = {}


def _op(*targets):
    def reg(fn):
        for t in targets:
            _OPS[t] = fn
        return fn

    return reg


def _out_dtype(node) -> torch.dtype:
    return _meta(node).dtype


def _common(node) -> torch.dtype:
    """The promoted dtype of a node's tensor and number operands."""
    vals = [_meta(a) if isinstance(a, torch.fx.Node) else a for a in node.args[:2]]
    return torch.result_type(*vals) if len(vals) == 2 else vals[0].dtype


def _unary(op):
    return lambda cv, node, a, kw: cv.n1(op, [cv.as_type(a[0], _out_dtype(node))], _out_dtype(node))


for _t, _o in ((aten.exp.default, "Exp"), (aten.log.default, "Log"), (aten.tanh.default, "Tanh"),
               (aten.sqrt.default, "Sqrt"), (aten.abs.default, "Abs"), (aten.neg.default, "Neg"),
               (aten.sign.default, "Sign"), (aten.floor.default, "Floor"), (aten.ceil.default, "Ceil"),
               (aten.round.default, "Round"), (aten.sigmoid.default, "Sigmoid"), (aten.erf.default, "Erf"),
               (aten.sin.default, "Sin"), (aten.cos.default, "Cos"), (aten.relu.default, "Relu"),
               (aten.reciprocal.default, "Reciprocal"), (aten.logical_not.default, "Not"),
               (aten.bitwise_not.default, "Not")):
    _OPS[_t] = _unary(_o)


@_op(aten.rsqrt.default)
def _rsqrt(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("Reciprocal", [cv.n1("Sqrt", [cv.as_type(a[0], dt)], dt)], dt)


@_op(aten.log1p.default, aten.expm1.default)
def _log1p_expm1(cv, node, a, kw):
    dt = _out_dtype(node)
    x, one = cv.as_type(a[0], dt), cv.const(1.0, dt)
    if node.target == aten.log1p.default:
        return cv.n1("Log", [cv.n1("Add", [x, one], dt)], dt)
    return cv.n1("Sub", [cv.n1("Exp", [x], dt), one], dt)


def _binary(op):
    def lower(cv, node, a, kw):
        dt = _out_dtype(node)
        x, y = cv.as_type(a[0], dt), cv.as_type(a[1], dt)
        alpha = kw.get("alpha", 1)
        if alpha != 1:
            y = cv.n1("Mul", [y, cv.const(alpha, dt)], dt)
        return cv.n1(op, [x, y], dt)

    return lower


for _t, _o in ((aten.add.Tensor, "Add"), (aten.add.Scalar, "Add"), (aten.sub.Tensor, "Sub"),
               (aten.sub.Scalar, "Sub"), (aten.mul.Tensor, "Mul"), (aten.mul.Scalar, "Mul"),
               (aten.maximum.default, "Max"), (aten.minimum.default, "Min"),
               (aten.pow.Tensor_Tensor, "Pow"), (aten.logical_and.default, "And"),
               (aten.logical_or.default, "Or"), (aten.bitwise_and.Tensor, "And"), (aten.bitwise_or.Tensor, "Or")):
    _OPS[_t] = _binary(_o)


@_op(aten.rsub.Scalar, aten.rsub.Tensor)
def _rsub(cv, node, a, kw):
    dt = _out_dtype(node)
    x, y = cv.as_type(a[0], dt), cv.as_type(a[1], dt)
    return cv.n1("Sub", [y, x], dt)


@_op(aten.pow.Tensor_Scalar)
def _pow(cv, node, a, kw):
    dt = _out_dtype(node)
    x = cv.as_type(a[0], dt)
    if a[1] == 2:
        return cv.n1("Mul", [x, x], dt)
    return cv.n1("Pow", [x, cv.const(a[1], dt)], dt)


def _float_of(node) -> torch.dtype:
    dt = _common(node)
    return dt if dt.is_floating_point else torch.float32


@_op(aten.div.Tensor, aten.div.Scalar, aten.div.Tensor_mode, aten.div.Scalar_mode)
def _div(cv, node, a, kw):
    """True division in the operands' float type; `floor` and `trunc`
    rounding in float (for integers in float32, exact below 2**24), so that
    no integer Div is emitted."""
    out, ft = _out_dtype(node), _float_of(node)
    q = cv.n1("Div", [cv.as_type(a[0], ft), cv.as_type(a[1], ft)], ft)
    mode = kw.get("rounding_mode")
    if mode == "floor":
        q = cv.n1("Floor", [q], ft)
    elif mode == "trunc":
        q = cv.n1("Mul", [cv.n1("Sign", [q], ft), cv.n1("Floor", [cv.n1("Abs", [q], ft)], ft)], ft)
    return cv.as_type(q, out)


@_op(aten.remainder.Tensor, aten.remainder.Scalar)
def _remainder(cv, node, a, kw):
    """Python's remainder (the divisor's sign): ONNX Mod fmod=0 for
    integers; for floats (where the specification requires fmod=1)
    a - floor(a / b) * b."""
    dt = _out_dtype(node)
    x, y = cv.as_type(a[0], dt), cv.as_type(a[1], dt)
    if not dt.is_floating_point:
        return cv.n1("Mod", [x, y], dt, fmod=0)
    q = cv.n1("Floor", [cv.n1("Div", [x, y], dt)], dt)
    return cv.n1("Sub", [x, cv.n1("Mul", [q, y], dt)], dt)


@_op(aten.fmod.Tensor, aten.fmod.Scalar)
def _fmod(cv, node, a, kw):
    """C's remainder (the dividend's sign): Mod with fmod=1."""
    dt = _out_dtype(node)
    return cv.n1("Mod", [cv.as_type(a[0], dt), cv.as_type(a[1], dt)], dt, fmod=1)


def _compare(op, negate=False):
    def lower(cv, node, a, kw):
        dt = _common(node)
        y = cv.n1(op, [cv.as_type(a[0], dt), cv.as_type(a[1], dt)], torch.bool)
        return cv.n1("Not", [y], torch.bool) if negate else y

    return lower


for _name, _o, _neg in (("eq", "Equal", False), ("ne", "Equal", True), ("lt", "Less", False),
                        ("le", "LessOrEqual", False), ("gt", "Greater", False), ("ge", "GreaterOrEqual", False)):
    for _ov in ("Tensor", "Scalar"):
        _OPS[getattr(getattr(aten, _name), _ov)] = _compare(_o, _neg)


@_op(aten.where.self)
def _where(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("Where", [cv.as_type(a[0], torch.bool), cv.as_type(a[1], dt), cv.as_type(a[2], dt)], dt)


@_op(aten.masked_fill.Scalar, aten.masked_fill.Tensor)
def _masked_fill(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("Where", [cv.as_type(a[1], torch.bool), cv.as_type(a[2], dt), cv.as_type(a[0], dt)], dt)


@_op(aten.clamp.default, aten.clamp.Tensor)
def _clamp(cv, node, a, kw):
    dt = _out_dtype(node)
    lo = a[1] if len(a) > 1 else kw.get("min")
    hi = a[2] if len(a) > 2 else kw.get("max")
    ins = [cv.as_type(a[0], dt), "" if lo is None else cv.as_type(lo, dt), "" if hi is None else cv.as_type(hi, dt)]
    return cv.n1("Clip", ins if hi is not None else ins[:2], dt)


@_op(aten.leaky_relu.default)
def _leaky_relu(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("LeakyRelu", [cv.as_type(a[0], dt)], dt, alpha=float(a[1] if len(a) > 1 else 0.01))


@_op(aten._to_copy.default, aten.clone.default, aten.alias.default, aten.lift_fresh_copy.default,
     aten.contiguous.default)
def _copy(cv, node, a, kw):
    return cv.as_type(a[0], _out_dtype(node))


# -- shapes -------------------------------------------------------------------


@_op(aten.view.default, aten._unsafe_view.default, aten.reshape.default, aten.squeeze.dim, aten.squeeze.dims,
     aten.squeeze.default, aten.unsqueeze.default)
def _reshape(cv, node, a, kw):
    return cv.reshape(cv.as_type(a[0], _out_dtype(node)), _meta(node).shape)


@_op(aten.expand.default)
def _expand(cv, node, a, kw):
    x = cv.as_type(a[0], _out_dtype(node))
    return cv.n1("Expand", [x, cv.i64(list(_meta(node).shape))], cv.dtype[x])


@_op(aten.permute.default)
def _permute(cv, node, a, kw):
    return cv.transpose(cv.as_type(a[0], _out_dtype(node)), a[1])


@_op(aten.cat.default)
def _cat(cv, node, a, kw):
    dt = _out_dtype(node)
    dim = a[1] if len(a) > 1 else kw.get("dim", 0)
    parts = [x for x, n in zip(a[0], node.args[0]) if not isinstance(n, torch.fx.Node) or _meta(n).numel() > 0]
    return cv.n1("Concat", [cv.as_type(x, dt) for x in parts], dt, axis=int(dim) % _meta(node).dim())


@_op(aten.split_with_sizes.default, aten.split.Tensor)
def _split(cv, node, a, kw):
    x = cv.as_type(a[0], _meta(node.args[0]).dtype)
    shape = _meta(node.args[0]).shape
    dim = int(a[2] if len(a) > 2 else kw.get("dim", 0)) % len(shape)
    sizes = [int(v.shape[dim]) for v in _meta(node)]
    return tuple(cv.node("Split", [x, cv.i64(sizes)], len(sizes), cv.dtype[x], axis=dim))


@_op(aten.slice.Tensor)
def _slice(cv, node, a, kw):
    x = cv.as_type(a[0], _out_dtype(node))
    shape = _meta(node.args[0]).shape
    dim = int(a[1] if len(a) > 1 else 0) % len(shape)
    n = int(shape[dim])
    start = a[2] if len(a) > 2 and a[2] is not None else 0
    end = a[3] if len(a) > 3 and a[3] is not None else n
    step = a[4] if len(a) > 4 else 1
    start, end = (min(max(v + n if v < 0 else v, 0), n) for v in (start, end))
    return cv.static_slice(x, [start], [end], [dim], [step])


@_op(aten.select.int)
def _select(cv, node, a, kw):
    x = cv.as_type(a[0], _out_dtype(node))
    dim = int(a[1]) % _meta(node.args[0]).dim()
    return cv.n1("Gather", [x, cv.const(int(a[2]), torch.int64)], cv.dtype[x], axis=dim)


@_op(aten.flip.default)
def _flip(cv, node, a, kw):
    return cv.flip(cv.as_type(a[0], _out_dtype(node)), a[1], _meta(node).shape)


@_op(aten.constant_pad_nd.default)
def _pad(cv, node, a, kw):
    """torch's pads (last dim first, (lo, hi) pairs; negative crops) as a
    Slice for the crops and a Pad for the rest."""
    dt = _out_dtype(node)
    x = cv.as_type(a[0], dt)
    shape = list(_meta(node.args[0]).shape)
    rank, pad = len(shape), list(a[1])
    los, his = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        los[rank - 1 - i], his[rank - 1 - i] = int(pad[2 * i]), int(pad[2 * i + 1])
    if any(v < 0 for v in los + his):
        x = cv.static_slice(x, [max(0, -lo) for lo in los], [shape[i] + min(0, his[i]) for i in range(rank)],
                            list(range(rank)))
        los, his = [max(0, v) for v in los], [max(0, v) for v in his]
    if any(los + his):
        value = a[2] if len(a) > 2 else 0.0
        x = cv.n1("Pad", [x, cv.i64(los + his), cv.const(value, dt)], dt)
    return x


@_op(aten.replication_pad1d.default, aten.replication_pad2d.default)
def _replication_pad(cv, node, a, kw):
    """Edge padding of the last 1 or 2 dims (kept out of the decomposition,
    which would fold it into index tables of the padded length)."""
    dt = _out_dtype(node)
    rank, pad = _meta(node).dim(), list(a[1])
    los, his = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        los[rank - 1 - i], his[rank - 1 - i] = int(pad[2 * i]), int(pad[2 * i + 1])
    return cv.n1("Pad", [cv.as_type(a[0], dt), cv.i64(los + his)], dt, mode="edge")


@_op(aten.embedding.default)
def _embedding(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("Gather", [cv.as_type(a[0], dt), cv.as_type(a[1], torch.int64)], dt, axis=0)


@_op(aten.index_select.default)
def _index_select(cv, node, a, kw):
    dt = _out_dtype(node)
    dim = int(a[1]) % _meta(node.args[0]).dim()
    return cv.n1("Gather", [cv.as_type(a[0], dt), cv.as_type(a[2], torch.int64)], dt, axis=dim)


@_op(aten.index.Tensor)
def _index(cv, node, a, kw):
    """x[..., idx, ...] with one index tensor (the others None): Gather."""
    idx = [(d, i) for d, i in enumerate(a[1]) if i is not None]
    if len(idx) != 1:
        raise NotImplementedError("ONNX export: aten.index.Tensor with more than one index tensor")
    dt = _out_dtype(node)
    d, i = idx[0]
    return cv.n1("Gather", [cv.as_type(a[0], dt), cv.as_type(i, torch.int64)], dt, axis=d)


@_op(aten.index_put.default)
def _index_put(cv, node, a, kw):
    """x[..., i0, .., ik, ...] = values (index_copy and indexed writes), the
    index tensors adjacent from dim d: ScatterND on x with those dims moved
    to the front."""
    x_meta, vals_meta = _meta(node.args[0]), _meta(node.args[2])
    dt, rank = _out_dtype(node), x_meta.dim()
    pos = [d for d, i in enumerate(a[1]) if i is not None]
    if (len(a) > 3 and a[3]) or kw.get("accumulate") or pos != list(range(pos[0], pos[-1] + 1)):
        raise NotImplementedError("ONNX export: aten.index_put.default other than a write at adjacent indices")
    d, k = pos[0], len(pos)
    idx_shape = torch.broadcast_shapes(*(tuple(_meta(node.args[1][p]).shape) for p in pos))
    idx = []
    for p in pos:  # each index as (..., 1), broadcast to the indexed shape
        i = cv.reshape(cv.as_type(a[1][p], torch.int64), list(_meta(node.args[1][p]).shape) + [1])
        idx.append(cv.n1("Expand", [i, cv.i64(list(idx_shape) + [1])], torch.int64))
    indices = idx[0] if k == 1 else cv.n1("Concat", idx, torch.int64, axis=len(idx_shape))
    perm = list(range(d, d + k)) + list(range(d)) + list(range(d + k, rank))
    xt = cv.transpose(cv.as_type(a[0], dt), perm)
    full = list(x_meta.shape[:d]) + list(idx_shape) + list(x_meta.shape[d + k:])
    v = cv.as_type(a[2], dt)
    if list(vals_meta.shape) != full:
        v = cv.n1("Expand", [v, cv.i64(full)], dt)
    ns = len(idx_shape)
    v = cv.transpose(v, list(range(d, d + ns)) + list(range(d)) + list(range(d + ns, ns + rank - k)))
    y = cv.n1("ScatterND", [xt, indices, v], dt)
    inv = [0] * rank
    for i, p in enumerate(perm):
        inv[p] = i
    return cv.transpose(y, inv)


@_op(aten.full_like.default, aten.zeros_like.default, aten.ones_like.default)
def _full_like(cv, node, a, kw):
    v = _meta(node)
    fill = {aten.zeros_like.default: 0, aten.ones_like.default: 1}.get(node.target, a[1] if len(a) > 1 else None)
    return cv.const(torch.full(tuple(v.shape), fill, dtype=v.dtype))


# -- reductions, normalization, matmul, convolution ---------------------------


def _dims(a, node, pos=1):
    rank = _meta(node.args[0]).dim()
    dims = a[pos] if len(a) > pos and a[pos] is not None else list(range(rank))
    return [int(d) % rank for d in ([dims] if isinstance(dims, int) else dims)]


@_op(aten.sum.dim_IntList, aten.sum.default)
def _sum(cv, node, a, kw):
    dt = _out_dtype(node)
    keep = int(a[2] if len(a) > 2 else kw.get("keepdim", False))
    return cv.n1("ReduceSum", [cv.as_type(a[0], dt), cv.i64(_dims(a, node))], dt, keepdims=keep)


def _reduce(op):
    def lower(cv, node, a, kw):
        dt = _out_dtype(node)
        keep = int(a[2] if len(a) > 2 else kw.get("keepdim", False))
        return cv.n1(op, [cv.as_type(a[0], dt)], dt, axes=_dims(a, node), keepdims=keep)

    return lower


_OPS[aten.mean.dim] = _reduce("ReduceMean")
_OPS[aten.amax.default] = _reduce("ReduceMax")
_OPS[aten.amin.default] = _reduce("ReduceMin")


@_op(aten.argmax.default, aten.argmin.default)
def _argmax(cv, node, a, kw):
    op = "ArgMax" if node.target == aten.argmax.default else "ArgMin"
    x = a[0] if isinstance(a[0], str) else cv.as_type(a[0], _meta(node.args[0]).dtype)
    return cv.n1(op, [x], torch.int64, axis=int(a[1]) % _meta(node.args[0]).dim(),
                 keepdims=int(a[2] if len(a) > 2 else False))


@_op(aten.cumsum.default)
def _cumsum(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("CumSum", [cv.as_type(a[0], dt), cv.const(int(a[1]) % _meta(node).dim(), torch.int64)], dt)


@_op(aten._softmax.default)
def _softmax(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("Softmax", [cv.as_type(a[0], dt)], dt, axis=int(a[1]) % _meta(node).dim())


@_op(aten._log_softmax.default)
def _log_softmax(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("Log", [_softmax(cv, node, a, kw)], dt)


@_op(aten.native_layer_norm.default)
def _layer_norm(cv, node, a, kw):
    """-> (y, None, None): the saved mean and rstd, which only a backward
    reads, are not exported."""
    dt = _meta(node)[0].dtype
    x, shape, w, b, eps = a[0], list(a[1]), a[2], a[3], a[4]
    w = cv.as_type(w if w is not None else torch.ones(shape), dt)
    ins = [cv.as_type(x, dt), w] + ([cv.as_type(b, dt)] if b is not None else [])
    return cv.n1("LayerNormalization", ins, dt, axis=-len(shape), epsilon=float(eps)), None, None


@_op(aten.mm.default, aten.bmm.default)
def _mm(cv, node, a, kw):
    dt = _out_dtype(node)
    return cv.n1("MatMul", [cv.as_type(a[0], dt), cv.as_type(a[1], dt)], dt)


@_op(aten.addmm.default)
def _addmm(cv, node, a, kw):
    dt = _out_dtype(node)
    y = cv.n1("MatMul", [cv.as_type(a[1], dt), cv.as_type(a[2], dt)], dt)
    if kw.get("alpha", 1) != 1:
        y = cv.n1("Mul", [y, cv.const(kw["alpha"], dt)], dt)
    bias = cv.as_type(a[0], dt)
    if kw.get("beta", 1) != 1:
        bias = cv.n1("Mul", [bias, cv.const(kw["beta"], dt)], dt)
    return cv.n1("Add", [y, bias], dt)


@_op(aten.convolution.default)
def _conv(cv, node, a, kw):
    """aten.convolution: Conv, or for a transposed convolution ConvTranspose,
    whose kernel layout (in, out/groups, k...) and arithmetic are torch's."""
    dt = _out_dtype(node)
    x, w_in, b, stride, padding, dilation, transposed, out_pad, groups = a
    spatial = len(stride)
    ins = [cv.as_type(x, dt), cv.as_type(w_in, dt)]
    if b is not None:
        ins.append(cv.as_type(b, dt))
    pads = [int(p) for p in padding] * 2
    if not transposed:
        return cv.n1("Conv", ins, dt, strides=list(stride), pads=pads, dilations=list(dilation), group=int(groups))
    if any(int(d) != 1 for d in dilation):
        raise NotImplementedError("ONNX export: dilated transposed convolution")
    w = ins[1]  # torch's (in, out/g, k) kernel is ConvTranspose's as it is: no flip
    return cv.n1("ConvTranspose", [ins[0], w] + ins[2:], dt, strides=list(stride), pads=pads,
                 output_padding=[int(p) for p in out_pad], group=int(groups))


# ---------------------------------------------------------------------------
# the FX walk
# ---------------------------------------------------------------------------


def _fold(target, args, kwargs):
    """Evaluate a node whose inputs are all known at export time, on the CPU."""
    if "device" in kwargs:
        kwargs = dict(kwargs, device="cpu")
    return target(*args, **kwargs)


def _is_known(v) -> bool:
    if isinstance(v, str):
        return False
    if isinstance(v, (list, tuple)):
        return all(_is_known(x) for x in v)
    return True


def _lower(cv: _Converter, ep: torch.export.ExportedProgram, input_names: list) -> list:
    from torch.export.graph_signature import InputKind, OutputKind

    sig = ep.graph_signature
    env: dict = {}
    user = iter(input_names)
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    for node, spec in zip(placeholders, sig.input_specs):
        if spec.kind == InputKind.USER_INPUT:
            name = next(user)
            env[node] = name
            cv.dtype[name] = _wide(_meta(node).dtype)
        elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
            env[node] = ep.state_dict[spec.target].detach().cpu() if spec.target in ep.state_dict \
                else ep.constants[spec.target].detach().cpu()
        elif spec.kind in (InputKind.CONSTANT_TENSOR, InputKind.CUSTOM_OBJ):
            env[node] = ep.constants[spec.target].detach().cpu()
        else:
            raise NotImplementedError(f"ONNX export: graph input of kind {spec.kind}")

    def read(v):
        if isinstance(v, torch.fx.Node):
            return env[v]
        if isinstance(v, (list, tuple)):
            return type(v)(read(x) for x in v)
        return v

    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target in _SKIP:
            continue
        args, kwargs = read(node.args), {k: read(v) for k, v in node.kwargs.items()}
        if node.target is operator.getitem:
            env[node] = args[0][args[1]]
        elif _is_known(list(args)) and _is_known(list(kwargs.values())):
            env[node] = _fold(node.target, args, kwargs)
        elif node.target in _OPS:
            env[node] = _OPS[node.target](cv, node, args, kwargs)
        else:
            raise NotImplementedError(f"ONNX export: unmapped ATen op '{node.target}'")

    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = []
    for spec, v in zip(sig.output_specs, out_node.args[0]):
        if spec.kind != OutputKind.USER_OUTPUT:
            raise NotImplementedError(f"ONNX export: the graph writes an input in place ({spec.kind})")
        outs.append((v, env[v]))
    return outs


def to_onnx(fn_or_module, example_args, *, name: str = "graph") -> bytes:
    """Export `fn_or_module` at `example_args` and serialize it as an ONNX
    model whose inputs are `input_0`, `input_1`, ... in argument order."""
    decomp = torch.export.default_decompositions()
    for op in (aten.replication_pad1d.default, aten.replication_pad2d.default):
        decomp.pop(op, None)  # lowered as Pad(mode="edge")
    ep = export_program(fn_or_module, example_args).run_decompositions(decomp)
    conv = _Converter(name)
    in_names = [f"input_{i}" for i in range(len(example_args))]
    outs = _lower(conv, ep, in_names)
    final: list[str] = []
    for node, v in outs:
        o = conv.as_type(v, _meta(node).dtype)
        # distinct graph-output names: ONNX forbids an output aliasing an
        # input, an initializer or another output
        if o in in_names or o in conv.g.initializers or o in final:
            o = conv.n1("Identity", [o], conv.dtype[o])
        final.append(o)
    conv.g.inputs = in_names
    conv.g.outputs = final
    for nm, x in zip(in_names, example_args):
        conv.g.io_types[nm] = (np.dtype(_NP_TYPE[x.dtype]), tuple(int(s) for s in x.shape))
    for nm, (node, _) in zip(final, outs):
        v = _meta(node)
        conv.g.io_types[nm] = (np.dtype(_NP_TYPE[v.dtype]), tuple(int(s) for s in v.shape))
    return encode_model(conv.g)


# ---------------------------------------------------------------------------
# model-specific exporters
# ---------------------------------------------------------------------------


def export_s2_decode_onnx(model, *, b=1, tc=256, tt=128, tr=256) -> bytes:
    """SynthesizerTrn.decode as ONNX at fixed bucket shapes (the reference's
    VITS graph from onnx_export.py), without prior noise."""
    return to_onnx(s2_decode_module(model), _s2_args(model, b, tc, tt, tr), name="s2_decode")


def export_s1_step_onnx(model, *, b=1, t_cache=2048) -> bytes:
    """One KV-cached S1 decode step as ONNX (the reference's sdec graph):
    decode_step_functional, as utils/export.py export_s1_step."""
    return to_onnx(s1_step_module(model), s1_step_args(model, b, t_cache), name="s1_decode_step")


def export_s1_prefill_onnx(model, *, b=1, t=512) -> bytes:
    """S1 prefill (the full prefix forward -> first logits and the K/V
    caches) as ONNX, the reference's t2s encoder graph: (xy_emb (b,t,D),
    attn_bias (1,1,t,t)) -> (logits (b,V), k, v (L,b,t,H,Dh))."""
    p = next(model.parameters())
    args = (torch.zeros((b, t, model.cfg.embedding_dim), dtype=p.dtype, device=p.device),
            torch.zeros((1, 1, t, t), dtype=p.dtype, device=p.device))
    return to_onnx(_Call(subset(model, ("h", "ar_predict_layer")), "prefill"), args, name="s1_prefill")


def export_vocoder_onnx(model: nn.Module, *, b=1, t=512) -> bytes:
    """BigVGAN / the v4 Generator mel -> waveform as ONNX, through
    utils/export.py plain_vocoder."""
    return to_onnx(plain_vocoder(model), vocoder_args(model, b, t), name="vocoder")
