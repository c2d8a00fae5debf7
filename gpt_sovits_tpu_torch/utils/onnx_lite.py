"""Dependency-free ONNX loader and writer, and a PyTorch executor.

A copy of the wire-format parser and writer of gpt_sovits_tpu/utils/onnx_lite.py
(`parse_model`, `Graph`, `Node`, `encode_model`; numpy and `struct`), with
the JAX executor replaced by one in torch. Neither `onnx` nor `onnxruntime`
is a dependency: the g2pW polyphone classifier (text/g2pw.py) and, later,
the MDX-Net vocal separator load their `.onnx` files through this module.

`OnnxModel(data, device=None)` runs a parsed graph op by op with torch on
`device`: the card unless the caller passes ``device="cpu"``. It carries
every op of the JAX executor (`_exec` and the `_ELEMENTWISE`/`_BINARY`
tables) with that executor's semantics, which in places are not ONNX's:
integer `Div` floors, `Mod` follows `fmod`, `Range` takes integer bounds,
`Resize` is `jax.image.resize` (half-pixel centres, antialiased when it
shrinks, Keys cubic), pools ignore `ceil_mode`, and `ConvTranspose` ignores
`dilations`. Shape-producing ops (Shape, Size, Reshape's target, Slice's
bounds) read their values on the host.

The writer emits just enough of ModelProto to round-trip graphs for tests.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch import resolve_device

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # two's complement, 64-bit
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, val


def _packed_varints(v, wt) -> list[int]:
    if wt == 0:
        return [v]
    out = []
    pos = 0
    mv = memoryview(v)
    while pos < len(mv):
        x, pos = _read_varint(mv, pos)
        out.append(x)
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# ONNX message subset
# ---------------------------------------------------------------------------

# TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = 1
    name = ""
    raw = b""
    f32: list[float] = []
    i32: list[int] = []
    i64: list[int] = []
    f64: list[float] = []
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            dims += [_signed(x) for x in _packed_varints(v, wt)]
        elif fnum == 2:
            dtype = v
        elif fnum == 4:
            f32 += list(np.frombuffer(v, "<f4")) if wt == 2 else [struct.unpack("<f", v)[0]]
        elif fnum == 5:
            i32 += _packed_varints(v, wt)
        elif fnum == 7:
            i64 += [_signed(x) for x in _packed_varints(v, wt)]
        elif fnum == 8:
            name = bytes(v).decode()
        elif fnum == 9:
            raw = bytes(v)
        elif fnum == 10:
            f64 += list(np.frombuffer(v, "<f8")) if wt == 2 else [struct.unpack("<d", v)[0]]
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif f32:
        arr = np.asarray(f32, np.float32)
    elif f64:
        arr = np.asarray(f64, np.float64)
    elif i64:
        arr = np.asarray(i64, np.int64)
    elif i32:
        arr = np.asarray(i32, np_dtype if np_dtype in (np.int32, np.int8, np.uint8, np.int16, np.uint16, np.bool_) else np.int32)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.astype(np_dtype, copy=False).reshape(dims if dims else ())


@dataclass
class Attr:
    name: str
    value: Any


def _parse_attr(buf: memoryview) -> Attr:
    name = ""
    val: Any = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            name = bytes(v).decode()
        elif fnum == 2:
            val = struct.unpack("<f", v)[0]
        elif fnum == 3:
            val = _signed(v)
        elif fnum == 4:
            val = bytes(v)
        elif fnum == 5:
            val = _parse_tensor(v)[1]
        elif fnum == 7:
            floats += list(np.frombuffer(v, "<f4")) if wt == 2 else [struct.unpack("<f", v)[0]]
        elif fnum == 8:
            ints += [_signed(x) for x in _packed_varints(v, wt)]
        elif fnum == 9:
            strings.append(bytes(v))
    if floats:
        val = floats
    elif ints:
        val = ints
    elif strings:
        val = strings
    return Attr(name, val)


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any]
    name: str = ""


@dataclass
class Graph:
    nodes: list[Node] = field(default_factory=list)
    initializers: dict[str, np.ndarray] = field(default_factory=dict)
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    name: str = "graph"
    # name -> (numpy dtype, shape) for graph inputs/outputs; the ONNX IR spec
    # requires TypeProto on graph I/O (onnxruntime refuses models without it)
    io_types: dict = field(default_factory=dict)


def _parse_node(buf: memoryview) -> Node:
    n = Node("", [], [], {})
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            n.inputs.append(bytes(v).decode())
        elif fnum == 2:
            n.outputs.append(bytes(v).decode())
        elif fnum == 3:
            n.name = bytes(v).decode()
        elif fnum == 4:
            n.op_type = bytes(v).decode()
        elif fnum == 5:
            a = _parse_attr(v)
            n.attrs[a.name] = a.value
    return n


def _parse_value_info(buf: memoryview) -> tuple[str, Optional[tuple]]:
    """ValueInfoProto -> (name, (np dtype, shape) or None)."""
    name = ""
    ty = None
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            name = bytes(v).decode()
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _fields(v):
                if f2 != 1:  # tensor_type
                    continue
                elem, dims = None, []
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        elem = v3
                    elif f3 == 2:  # TensorShapeProto
                        for f4, _, v4 in _fields(v3):
                            if f4 == 1:  # Dimension
                                dim = -1
                                for f5, _, v5 in _fields(v4):
                                    if f5 == 1:
                                        dim = _signed(v5)
                                dims.append(dim)
                if elem in _DTYPES:
                    ty = (np.dtype(_DTYPES[elem]), tuple(dims))
    return name, ty


def _parse_graph(buf: memoryview) -> Graph:
    g = Graph()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(v))
        elif fnum == 2:
            g.name = bytes(v).decode()
        elif fnum == 5:
            name, arr = _parse_tensor(v)
            g.initializers[name] = arr
        elif fnum == 11:
            name, ty = _parse_value_info(v)
            g.inputs.append(name)
            if ty is not None:
                g.io_types[name] = ty
        elif fnum == 12:
            name, ty = _parse_value_info(v)
            g.outputs.append(name)
            if ty is not None:
                g.io_types[name] = ty
    g.inputs = [i for i in g.inputs if i not in g.initializers]
    return g


def parse_model(data: bytes) -> Graph:
    mv = memoryview(data)
    for fnum, wt, v in _fields(mv):
        if fnum == 7:
            return _parse_graph(v)
    raise ValueError("no graph in ONNX model")


# ---------------------------------------------------------------------------
# writer (subset: enough to round-trip Graph)
# ---------------------------------------------------------------------------


def _tag(out: bytearray, fnum: int, wt: int) -> None:
    _write_varint(out, (fnum << 3) | wt)


def _put_bytes(out: bytearray, fnum: int, data: bytes) -> None:
    _tag(out, fnum, 2)
    _write_varint(out, len(data))
    out += data


def _put_str(out: bytearray, fnum: int, s: str) -> None:
    _put_bytes(out, fnum, s.encode())


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    for d in arr.shape:
        _tag(out, 1, 0)
        _write_varint(out, d)
    _tag(out, 2, 0)
    _write_varint(out, _DTYPE_CODES[np.dtype(arr.dtype)])
    _put_str(out, 8, name)
    _put_bytes(out, 9, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _encode_attr(name: str, value: Any) -> bytes:
    out = bytearray()
    _put_str(out, 1, name)
    if isinstance(value, float):
        _tag(out, 2, 5)
        out += struct.pack("<f", value)
        t = 1
    elif isinstance(value, (bool, int, np.integer)):
        _tag(out, 3, 0)
        _write_varint(out, int(value))
        t = 2
    elif isinstance(value, (str, bytes)):
        _put_bytes(out, 4, value.encode() if isinstance(value, str) else value)
        t = 3
    elif isinstance(value, np.ndarray):
        _put_bytes(out, 5, _encode_tensor("", value))
        t = 4
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for f in value:
            _tag(out, 7, 5)
            out += struct.pack("<f", f)
        t = 6
    elif isinstance(value, (list, tuple)):
        for i in value:
            _tag(out, 8, 0)
            _write_varint(out, int(i))
        t = 7
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    _tag(out, 20, 0)
    _write_varint(out, t)
    return bytes(out)


def _encode_value_info(name: str, ty: Optional[tuple] = None) -> bytes:
    out = bytearray()
    _put_str(out, 1, name)
    if ty is not None:
        dtype, shape = ty
        tensor = bytearray()
        _tag(tensor, 1, 0)
        _write_varint(tensor, _DTYPE_CODES[np.dtype(dtype)])  # elem_type
        shp = bytearray()
        for d in shape:
            dim = bytearray()
            if int(d) >= 0:
                _tag(dim, 1, 0)
                _write_varint(dim, int(d))
            else:  # unknown dim -> dim_param
                _put_str(dim, 2, "dyn")
            _put_bytes(shp, 1, bytes(dim))
        _put_bytes(tensor, 2, bytes(shp))
        typ = bytearray()
        _put_bytes(typ, 1, bytes(tensor))  # TypeProto.tensor_type
        _put_bytes(out, 2, bytes(typ))  # ValueInfoProto.type
    return bytes(out)


def encode_model(g: Graph, opset: int = 17) -> bytes:
    gout = bytearray()
    for n in g.nodes:
        nb = bytearray()
        for i in n.inputs:
            _put_str(nb, 1, i)
        for o in n.outputs:
            _put_str(nb, 2, o)
        if n.name:
            _put_str(nb, 3, n.name)
        _put_str(nb, 4, n.op_type)
        for k, v in n.attrs.items():
            _put_bytes(nb, 5, _encode_attr(k, v))
        _put_bytes(gout, 1, bytes(nb))
    _put_str(gout, 2, g.name)
    for name, arr in g.initializers.items():
        _put_bytes(gout, 5, _encode_tensor(name, arr))
    for i in g.inputs:
        _put_bytes(gout, 11, _encode_value_info(i, g.io_types.get(i)))
    for o in g.outputs:
        _put_bytes(gout, 12, _encode_value_info(o, g.io_types.get(o)))

    out = bytearray()
    _tag(out, 1, 0)
    _write_varint(out, 8)  # ir_version
    ops = bytearray()
    _tag(ops, 2, 0)
    _write_varint(ops, opset)  # OperatorSetIdProto.version
    _put_bytes(out, 8, bytes(ops))
    _put_bytes(out, 7, bytes(gout))
    return bytes(out)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------



def _np_dims(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.int64).reshape(-1)


def _conv_pads(attrs, spatial, x_shape, w_shape, strides, dilations):
    if "pads" in attrs:
        p = attrs["pads"]
        return [(int(p[i]), int(p[i + spatial])) for i in range(spatial)]
    ap = attrs.get("auto_pad", b"NOTSET")
    ap = ap.decode() if isinstance(ap, bytes) else ap
    if ap in ("NOTSET", "VALID", ""):
        return [(0, 0)] * spatial
    pads = []
    for i in range(spatial):
        in_i = x_shape[2 + i]
        k = (w_shape[2 + i] - 1) * dilations[i] + 1
        out_i = -(-in_i // strides[i])
        total = max(0, (out_i - 1) * strides[i] + k - in_i)
        if ap == "SAME_UPPER":
            pads.append((total // 2, total - total // 2))
        else:
            pads.append((total - total // 2, total // 2))
    return pads


def _flat_pads(pads) -> list[int]:
    """[(lo, hi) per leading dim] -> F.pad's list, last dim first."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


_TORCH_DTYPES = {np.dtype(k): v for k, v in {
    np.float32: torch.float32, np.uint8: torch.uint8, np.int8: torch.int8, np.uint16: torch.uint16,
    np.int16: torch.int16, np.int32: torch.int32, np.int64: torch.int64, np.bool_: torch.bool,
    np.float16: torch.float16, np.float64: torch.float64, np.uint32: torch.uint32, np.uint64: torch.uint64,
}.items()}


def _is_float(x: torch.Tensor) -> bool:
    return x.is_floating_point()


def _dims(x, axes) -> tuple:
    return tuple(axes) if axes is not None else tuple(range(x.ndim))


def _prod(x, axes, keep):
    """torch.prod takes one dim: reduce them one at a time."""
    dims = sorted((d % x.ndim for d in _dims(x, axes)), reverse=True)
    for d in dims:
        x = x.prod(d, keepdim=True)
    return x if keep else x.reshape([s for i, s in enumerate(x.shape) if i not in dims])


_REDUCE = {
    "ReduceMean": lambda x, axes, keep: (x if _is_float(x) else x.float()).mean(dim=_dims(x, axes), keepdim=keep),
    "ReduceSum": lambda x, axes, keep: x.sum(dim=_dims(x, axes), keepdim=keep),
    "ReduceMax": lambda x, axes, keep: x.amax(dim=_dims(x, axes), keepdim=keep),
    "ReduceMin": lambda x, axes, keep: x.amin(dim=_dims(x, axes), keepdim=keep),
    "ReduceProd": _prod,
}


def _pad_index(n: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Source index of each padded position along one axis (np.pad's edge /
    reflect)."""
    i = np.arange(-lo, n + hi)
    if mode == "edge":
        i = np.clip(i, 0, n - 1)
    else:  # reflect, without repeating the edge sample
        period = 2 * (n - 1)
        i = np.abs(i) % period if period else np.zeros_like(i)
        i = np.where(i >= n, period - i, i)
    return torch.from_numpy(i.astype(np.int64))


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_RESIZE_KERNELS = {
    "linear": lambda x: torch.clamp(1 - x.abs(), min=0),
    "cubic": _keys_cubic,
}


def _resize_weights(m: int, n: int, kernel, device) -> torch.Tensor:
    """(m, n) weights of jax.image.resize along one axis: half-pixel
    centres, the kernel widened by the shrink factor (antialias), weights
    normalized per output, and samples outside the input zeroed."""
    inv_scale = m / n
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x: torch.Tensor, out_shape: list[int], method: str) -> torch.Tensor:
    """jax.image.resize(x, out_shape, method) in torch."""
    dims = [d for d in range(x.ndim) if x.shape[d] != out_shape[d]]
    if method == "nearest":
        for d in dims:
            m, n = x.shape[d], out_shape[d]
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).to(torch.int64)
            x = x.index_select(d, idx.to(x.device))
        return x
    if not _is_float(x):
        x = x.float()
    for d in dims:
        w = _resize_weights(x.shape[d], out_shape[d], _RESIZE_KERNELS[method], x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w, dims=([-1], [0])), -1, d)
    return x


def _conv_nd(spatial: int):
    if spatial not in (1, 2):
        raise NotImplementedError(f"Conv with {spatial} spatial dims")
    return (F.conv1d, F.conv_transpose1d) if spatial == 1 else (F.conv2d, F.conv_transpose2d)


class OnnxModel:
    """Parsed ONNX graph executable with torch on one device.

    `run({input: array or tensor, ...})` -> list of output tensors on the
    model's device. `device=None` means the card, and raises without one.
    """

    def __init__(self, data: bytes, device=None):
        self.device = resolve_device(device)
        self.graph = parse_model(data)
        self.params = {k: self._tensor(v) for k, v in self.graph.initializers.items()}

    @staticmethod
    def from_file(path: str, device=None) -> "OnnxModel":
        with open(path, "rb") as f:
            return OnnxModel(f.read(), device=device)

    @property
    def input_names(self) -> list[str]:
        return list(self.graph.inputs)

    def _tensor(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        a = np.asarray(v)
        return torch.from_numpy(np.array(a, dtype=a.dtype, copy=True)).to(self.device)

    @torch.no_grad()
    def run(self, feeds: dict) -> list:
        env: dict[str, Any] = dict(self.params)
        for k, v in feeds.items():
            env[k] = self._tensor(v)
        for node in self.graph.nodes:
            outs = self._exec(node, env)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        return [env[o] for o in self.graph.outputs]

    # -- op dispatch --------------------------------------------------------

    def _exec(self, n: Node, env: dict) -> Sequence[Any]:
        op = n.op_type
        a = n.attrs
        dev = self.device

        def inp(i, default=None):
            if i >= len(n.inputs) or not n.inputs[i]:
                return default
            return env[n.inputs[i]]

        x = inp(0)

        if op in _ELEMENTWISE:
            return (_ELEMENTWISE[op](x),)
        if op == "Mod":
            # fmod=1 -> C semantics (sign follows the dividend); fmod=0 ->
            # Python semantics (sign follows the divisor)
            return ((torch.fmod if a.get("fmod") else torch.remainder)(x, inp(1)),)
        if op in _BINARY:
            return (_BINARY[op](x, inp(1)),)

        if op == "Conv":
            w = inp(1)
            spatial = w.ndim - 2
            strides = [int(s) for s in a.get("strides", [1] * spatial)]
            dil = [int(d) for d in a.get("dilations", [1] * spatial)]
            group = int(a.get("group", 1))
            pads = _conv_pads(a, spatial, x.shape, w.shape, strides, dil)
            conv, _ = _conv_nd(spatial)
            y = conv(F.pad(x, _flat_pads(pads)), w, inp(2), stride=strides, dilation=dil, groups=group)
            return (y,)

        if op == "ConvTranspose":
            w = inp(1)  # (Cin, Cout/g, k...), torch's own layout
            spatial = w.ndim - 2
            strides = [int(s) for s in a.get("strides", [1] * spatial)]
            group = int(a.get("group", 1))
            pads_attr = [int(p) for p in a.get("pads", [0] * (2 * spatial))]
            out_pad = [int(p) for p in a.get("output_padding", [0] * spatial)]
            _, convt = _conv_nd(spatial)
            y = convt(x, w, None, stride=strides, groups=group)  # the full output, (in - 1) * s + k
            # crop the begin pads, crop the end pads less output_padding (or
            # extend by what output_padding exceeds them)
            y = F.pad(y, _flat_pads([(-pads_attr[i], out_pad[i] - pads_attr[i + spatial]) for i in range(spatial)]))
            b = inp(2)
            if b is not None:
                y = y + b.reshape((1, -1) + (1,) * spatial)
            return (y,)

        if op == "BatchNormalization":
            scale, bias, mean, var = inp(1), inp(2), inp(3), inp(4)
            eps = a.get("epsilon", 1e-5)
            shp = (1, -1) + (1,) * (x.ndim - 2)
            return ((x - mean.reshape(shp)) / torch.sqrt(var.reshape(shp) + eps) * scale.reshape(shp)
                    + bias.reshape(shp),)

        if op == "InstanceNormalization":
            scale, bias = inp(1), inp(2)
            eps = a.get("epsilon", 1e-5)
            axes = tuple(range(2, x.ndim))
            mu = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, keepdim=True, unbiased=False)
            shp = (1, -1) + (1,) * (x.ndim - 2)
            return ((x - mu) / torch.sqrt(var + eps) * scale.reshape(shp) + bias.reshape(shp),)

        if op == "LayerNormalization":
            scale, bias = inp(1), inp(2)
            axis = int(a.get("axis", -1))
            eps = a.get("epsilon", 1e-5)
            axes = tuple(range(axis % x.ndim, x.ndim))
            mu = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, keepdim=True, unbiased=False)
            y = (x - mu) / torch.sqrt(var + eps) * scale
            if bias is not None:
                y = y + bias
            return (y,)

        if op == "Gemm":
            A, B, C = x, inp(1), inp(2)
            if a.get("transA", 0):
                A = A.T
            if a.get("transB", 0):
                B = B.T
            y = a.get("alpha", 1.0) * (A @ B)
            if C is not None:
                y = y + a.get("beta", 1.0) * C
            return (y,)

        if op == "MatMul":
            return (torch.matmul(x, inp(1)),)

        if op == "Softmax":
            return (torch.softmax(x, dim=int(a.get("axis", -1))),)

        if op == "Reshape":
            shape = [int(s) for s in _np_dims(inp(1))]
            shape = [x.shape[i] if s == 0 and a.get("allowzero", 0) == 0 else s for i, s in enumerate(shape)]
            return (x.reshape(shape),)

        if op == "Transpose":
            perm = a.get("perm")
            return (x.permute(*(perm if perm else range(x.ndim - 1, -1, -1))),)

        if op == "Concat":
            return (torch.cat([env[i] for i in n.inputs], dim=int(a["axis"])),)

        if op == "Split":
            axis = int(a.get("axis", 0))
            if len(n.inputs) > 1 and n.inputs[1]:
                sizes = [int(s) for s in _np_dims(inp(1))]
            elif "split" in a:
                sizes = [int(s) for s in a["split"]]
            else:
                k = len(n.outputs)
                sizes = [x.shape[axis] // k] * k
            return tuple(torch.split(x, sizes, dim=axis))

        if op == "Slice":
            if len(n.inputs) > 1:  # opset >= 10
                starts = _np_dims(inp(1))
                ends = _np_dims(inp(2))
                axes = _np_dims(inp(3)) if inp(3) is not None else np.arange(len(starts))
                steps = _np_dims(inp(4)) if inp(4) is not None else np.ones(len(starts), np.int64)
            else:
                starts = _np_dims(a["starts"])
                ends = _np_dims(a["ends"])
                axes = _np_dims(a.get("axes", list(range(len(starts)))))
                steps = np.ones(len(starts), np.int64)
            y = x
            for s, e, ax, st in zip(starts, ends, axes, steps):
                ax = int(ax) % x.ndim
                dim = x.shape[ax]
                s, e = int(np.clip(s + dim if s < 0 else s, 0, dim)), int(np.clip(e + dim if e < 0 else e, -1 if st < 0 else 0, dim))
                # a clipped end of -1 with a negative step means "through
                # index 0 inclusive", which Python can only express as None
                idx = range(dim)[slice(s, None if (st < 0 and e < 0) else e, int(st))]
                if idx.step == 1:
                    y = y.narrow(ax, idx.start, len(idx))
                else:  # torch views take no negative step
                    y = y.index_select(ax, torch.as_tensor(list(idx), dtype=torch.int64, device=y.device))
            return (y,)

        if op in ("Squeeze", "Unsqueeze"):
            if len(n.inputs) > 1 and n.inputs[1]:
                axes = [int(v) for v in _np_dims(inp(1))]
            else:
                axes = [int(v) for v in a.get("axes", [])]
            if op == "Squeeze":
                if not axes:
                    return (x.squeeze(),)
                return (x.squeeze(tuple(ax % x.ndim for ax in axes)),)
            y = x
            for ax in sorted(ax % (x.ndim + len(axes)) for ax in axes):
                y = y.unsqueeze(ax)
            return (y,)

        if op == "Shape":
            return (torch.tensor(list(x.shape), dtype=torch.int64, device=dev),)
        if op == "Size":
            return (torch.tensor(int(x.numel()), dtype=torch.int64, device=dev),)

        if op == "Gather":
            axis = int(a.get("axis", 0)) % x.ndim
            idx = inp(1).to(torch.int64)
            idx = torch.where(idx < 0, idx + x.shape[axis], idx)  # negative indices count from the end
            y = x.index_select(axis, idx.reshape(-1))
            return (y.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:])),)

        if op == "Cast":
            return (x.to(_TORCH_DTYPES[np.dtype(_DTYPES[int(a["to"])])]),)

        if op == "Constant":
            for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
                if key in a:
                    v = a[key]
                    if key == "value_float" or key == "value_floats":
                        v = np.asarray(v, np.float32)
                    elif key == "value_int" or key == "value_ints":
                        v = np.asarray(v, np.int64)
                    return (self._tensor(v),)
            raise ValueError("Constant without value")

        if op == "ConstantOfShape":
            shape = [int(s) for s in _np_dims(x)]
            val = a.get("value")
            fill = np.asarray(val).reshape(-1)[:1] if val is not None else np.zeros(1, np.float32)
            return (self._tensor(fill).reshape(()).expand(shape).clone(),)

        if op == "Expand":
            shape = [int(s) for s in _np_dims(inp(1))]
            shape = list(np.broadcast_shapes(tuple(x.shape), tuple(shape)))
            return (x.broadcast_to(shape),)

        if op == "Range":
            return (torch.arange(int(inp(0)), int(inp(1)), int(inp(2)), device=dev),)

        if op == "Where":
            return (torch.where(x.to(torch.bool), inp(1), inp(2)),)

        if op in _REDUCE:
            if len(n.inputs) > 1 and n.inputs[1]:
                axes = tuple(int(v) for v in _np_dims(inp(1)))
            else:
                axes = tuple(int(v) for v in a.get("axes", [])) or None
            return (_REDUCE[op](x, axes, bool(a.get("keepdims", 1))),)

        if op == "Clip":
            lo = inp(1) if len(n.inputs) > 1 else a.get("min")
            hi = inp(2) if len(n.inputs) > 2 else a.get("max")
            lo, hi = (v if v is None or isinstance(v, torch.Tensor) else torch.tensor(v, dtype=x.dtype, device=dev)
                      for v in (lo, hi))
            return (torch.clamp(x, lo, hi),)

        if op == "LeakyRelu":
            alpha = a.get("alpha", 0.01)
            return (torch.where(x >= 0, x, alpha * x),)

        if op == "PRelu":
            s = inp(1)
            return (torch.where(x >= 0, x, s * x),)

        if op == "Elu":
            alpha = a.get("alpha", 1.0)
            return (torch.where(x >= 0, x, alpha * (torch.exp(x) - 1)),)

        if op == "Flatten":
            axis = int(a.get("axis", 1))
            lead = int(np.prod(x.shape[:axis])) if axis else 1
            return (x.reshape(lead, -1),)

        if op in ("Identity", "Dropout"):
            return (x,) + ((torch.ones_like(x, dtype=torch.bool),) if op == "Dropout" and len(n.outputs) > 1 else ())

        if op in ("AveragePool", "MaxPool", "GlobalAveragePool"):
            if op == "GlobalAveragePool":
                return (x.mean(dim=tuple(range(2, x.ndim)), keepdim=True),)
            k = [int(v) for v in a["kernel_shape"]]
            spatial = len(k)
            if spatial not in (1, 2, 3):
                raise NotImplementedError(f"{op} with {spatial} spatial dims")
            strides = [int(s) for s in a.get("strides", [1] * spatial)]
            pads = _conv_pads(a, spatial, x.shape, (0, 0, *k), strides, [1] * spatial)
            fp = _flat_pads(pads)
            if op == "MaxPool":
                pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[spatial - 1]
                return (pool(F.pad(x, fp, value=-float("inf")), k, strides),)
            # the mean over the window's real samples: pads count as none
            pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[spatial - 1]
            total = pool(F.pad(x, fp), k, strides)
            cnt = pool(F.pad(torch.ones_like(x), fp), k, strides)
            return (total / cnt,)

        if op == "Pad":
            mode = a.get("mode", b"constant")
            mode = mode.decode() if isinstance(mode, bytes) else mode
            pads = _np_dims(inp(1)) if len(n.inputs) > 1 else _np_dims(a["pads"])
            half = len(pads) // 2
            pw = [(int(pads[i]), int(pads[i + half])) for i in range(half)]
            if mode == "constant":
                cval = inp(2)
                return (F.pad(x, _flat_pads(pw), value=0.0 if cval is None else cval.item()),)
            if mode not in ("reflect", "edge"):
                raise KeyError(mode)
            y = x
            for ax, (lo, hi) in enumerate(pw):
                if lo or hi:
                    y = y.index_select(ax, _pad_index(y.shape[ax], lo, hi, mode).to(y.device))
            return (y,)

        if op == "Einsum":
            eq = a["equation"]
            eq = eq.decode() if isinstance(eq, bytes) else eq
            return (torch.einsum(eq, *[env[i] for i in n.inputs]),)

        if op in ("ArgMax", "ArgMin"):
            axis = int(a.get("axis", 0))
            keep = bool(a.get("keepdims", 1))
            return ((torch.argmax if op == "ArgMax" else torch.argmin)(x, dim=axis, keepdim=keep),)

        if op == "CumSum":
            axis = int(_np_dims(inp(1))[0])
            if a.get("exclusive", 0):
                raise NotImplementedError("exclusive CumSum")
            if a.get("reverse", 0):
                return (torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis), (axis,)),)
            return (torch.cumsum(x, dim=axis),)

        if op == "ScatterND":
            idx = inp(1).to(torch.int64)
            y = x.clone()
            y[tuple(torch.movedim(idx, -1, 0))] = inp(2).to(y.dtype)
            return (y,)

        if op == "Tile":
            reps = [int(r) for r in _np_dims(inp(1))]
            return (torch.tile(x, reps),)

        if op == "Resize":
            # scales or sizes; nearest / linear / cubic as jax.image.resize
            scales = inp(2)
            sizes = inp(3) if len(n.inputs) > 3 else None
            if sizes is not None and sizes.numel():
                out_shape = [int(s) for s in _np_dims(sizes)]
            else:
                sc = scales.detach().cpu().numpy().reshape(-1)
                out_shape = [int(round(d * s)) for d, s in zip(x.shape, sc)]
            mode = a.get("mode", b"nearest")
            mode = mode.decode() if isinstance(mode, bytes) else mode
            if mode not in ("nearest", "linear", "cubic"):
                raise KeyError(mode)
            return (_resize(x, out_shape, mode),)

        raise NotImplementedError(f"ONNX op {op} (node {n.name})")


def _div(x, y):
    if _is_float(x) or _is_float(y):
        return x / y
    return torch.div(x, y, rounding_mode="floor")


_ELEMENTWISE = {
    "Relu": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Erf": torch.erf,
    "Sqrt": torch.sqrt,
    "Exp": torch.exp,
    "Log": torch.log,
    "Neg": lambda x: -x,
    "Abs": torch.abs,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Reciprocal": lambda x: 1.0 / x,
    "Not": lambda x: torch.logical_not(x.to(torch.bool)),
    "Softplus": F.softplus,
    "Sin": torch.sin,
    "Cos": torch.cos,
    "Sign": torch.sign,
    "Round": torch.round,  # half to even, as jnp.round
    "Gelu": lambda x: F.gelu(x, approximate="none"),
    "HardSwish": lambda x: x * torch.clamp(x / 6 + 0.5, 0, 1),
}

_BINARY = {
    "Add": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": _div,
    "Pow": torch.pow,
    "Equal": torch.eq,
    "Greater": torch.gt,
    "GreaterOrEqual": torch.ge,
    "Less": torch.lt,
    "LessOrEqual": torch.le,
    "And": torch.logical_and,
    "Or": torch.logical_or,
    "Max": torch.maximum,
    "Min": torch.minimum,
    "Mod": torch.remainder,
}
