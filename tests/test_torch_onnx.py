"""The port's ONNX executor (torch) against the JAX package's
`utils/onnx_lite.OnnxModel` on the same graphs and inputs: one case per op
family, covering every op of the JAX executor's `_exec` and its
`_ELEMENTWISE`/`_BINARY` tables; floats within 1e-5, integers and booleans
exactly. Graphs are written by the port's `encode_model` and read by both
packages' parsers; the wire format round-trips between the two packages;
tests/test_onnx_lite.py's conv-stack and BERT-block graphs run on both."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpt_sovits_tpu.utils import onnx_lite as jol
from gpt_sovits_tpu_torch.utils import onnx_lite as pol
from gpt_sovits_tpu_torch.utils.onnx_lite import Graph, Node, OnnxModel, encode_model, parse_model

RNG = np.random.default_rng(0)


def f32(*shape, lo=-2.0, hi=2.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def i64(*vals):
    return np.asarray(vals, np.int64)


def run_both(g: Graph, feeds: dict):
    """-> [(port output, JAX output)] after checking shapes and values."""
    data = encode_model(g)
    want = [np.asarray(o) for o in jol.OnnxModel(data).run(feeds)]
    got = [o.numpy() for o in OnnxModel(data, device="cpu").run(feeds)]
    assert len(got) == len(want) == len(g.outputs)
    for name, p, j in zip(g.outputs, got, want):
        assert p.shape == j.shape, (name, p.shape, j.shape)
        if np.issubdtype(p.dtype, np.floating) or np.issubdtype(j.dtype, np.floating):
            assert np.issubdtype(p.dtype, np.floating) == np.issubdtype(j.dtype, np.floating), name
            np.testing.assert_allclose(p.astype(np.float64), j.astype(np.float64), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            assert (p.dtype == np.bool_) == (j.dtype == np.bool_), name
            np.testing.assert_array_equal(p, j, err_msg=name)
    return list(zip(got, want))


def graph(nodes, inputs, outputs, inits=None):
    return Graph(nodes=nodes, initializers=inits or {}, inputs=inputs, outputs=outputs)


# ---------------------------------------------------------------------------
# one graph per op family
# ---------------------------------------------------------------------------

UNARY = ["Relu", "Sigmoid", "Tanh", "Erf", "Sqrt", "Exp", "Log", "Neg", "Abs", "Floor", "Ceil", "Reciprocal",
         "Softplus", "Sin", "Cos", "Sign", "Round", "Gelu", "HardSwish"]
BINARY = ["Add", "Sub", "Mul", "Div", "Pow", "Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual", "Max",
          "Min", "Mod"]


def case_elementwise():
    pos = {"Sqrt", "Log", "Reciprocal"}
    nodes = [Node(op, ["xp" if op in pos else "x"], [op], {}) for op in UNARY] + [Node("Not", ["m"], ["Not"], {})]
    x = f32(3, 7, lo=-30, hi=30)
    x[0, :6] = [0.5, 1.5, 2.5, -0.5, -2.5, 0.0]  # Round halves to even, Sign of 0
    feeds = {"x": x, "xp": f32(3, 7, lo=0.1, hi=9), "m": RNG.random((3, 7)) > 0.5}
    return graph(nodes, ["x", "xp", "m"], UNARY + ["Not"]), feeds


def case_binary_float():
    nodes = [Node(op, ["a", "b"], [op], {}) for op in BINARY if op != "Pow"]
    nodes += [Node("Pow", ["ap", "b"], ["Pow"], {}), Node("Mod", ["a", "b"], ["fmod"], {"fmod": 1}),
              Node("And", ["m", "n"], ["And"], {}), Node("Or", ["m", "n"], ["Or"], {})]
    a, b = f32(4, 5, lo=-6, hi=6), f32(1, 5, lo=0.5, hi=3) * np.where(RNG.random((1, 5)) > 0.5, 1, -1)
    a[0, 0] = b[0, 0]  # one Equal hit
    feeds = {"a": a, "b": b.astype(np.float32), "ap": f32(4, 5, lo=0.1, hi=3),
             "m": RNG.random((4, 5)) > 0.5, "n": RNG.random((4, 5)) > 0.5}
    return graph(nodes, list(feeds), BINARY + ["fmod", "And", "Or"]), feeds


def case_binary_int():
    ops = ["Add", "Sub", "Mul", "Div", "Max", "Min", "Equal", "Greater", "Less", "Mod"]
    nodes = [Node(op, ["a", "b"], [op], {}) for op in ops]
    nodes += [Node("Mod", ["a", "b"], ["fmod"], {"fmod": 1}), Node("Pow", ["a", "e"], ["Pow"], {})]
    feeds = {"a": i64(-7, -3, 0, 5, 9, 12), "b": i64(2, -4, 3, -2, 4, 5), "e": i64(2, 3, 1, 0, 2, 1)}
    return graph(nodes, ["a", "b", "e"], ops + ["fmod", "Pow"]), feeds


def case_conv():
    x2, x1 = f32(2, 4, 9, 11), f32(2, 4, 17)
    inits = {"w2": f32(6, 2, 3, 3), "b2": f32(6), "w1": f32(5, 4, 4), "b1": f32(5), "w3": f32(3, 4, 2, 3)}
    nodes = [
        Node("Conv", ["x2", "w2", "b2"], ["c2"], {"strides": [2, 1], "pads": [1, 2, 0, 1], "group": 2,
                                                  "dilations": [1, 2]}),
        Node("Conv", ["x1", "w1", "b1"], ["c1"], {"auto_pad": "SAME_UPPER", "strides": [2]}),
        Node("Conv", ["x1", "w1"], ["c1l"], {"auto_pad": "SAME_LOWER", "dilations": [2]}),
        Node("Conv", ["x2", "w3"], ["c3"], {"auto_pad": "VALID"}),
    ]
    return graph(nodes, ["x2", "x1"], ["c2", "c1", "c1l", "c3"], inits), {"x2": x2, "x1": x1}


def case_conv_transpose():
    inits = {"w1": f32(4, 3, 5), "b1": f32(6), "w2": f32(3, 2, 4, 3), "b2": f32(2)}
    nodes = [
        Node("ConvTranspose", ["x1", "w1", "b1"], ["t1"], {"strides": [3], "group": 2, "pads": [1, 2],
                                                           "output_padding": [1]}),
        Node("ConvTranspose", ["x2", "w2", "b2"], ["t2"], {"strides": [2, 2], "pads": [1, 0, 1, 2]}),
        Node("ConvTranspose", ["x1", "w1"], ["t3"], {"group": 2, "output_padding": [0]}),
    ]
    return graph(nodes, ["x1", "x2"], ["t1", "t2", "t3"], inits), {"x1": f32(2, 4, 7), "x2": f32(1, 3, 5, 6)}


def case_norms():
    inits = {"s": f32(3), "b": f32(3), "mu": f32(3), "var": f32(3, lo=0.5, hi=1.5), "g": f32(5), "be": f32(5),
             "g2": f32(3, 5)}
    nodes = [
        Node("BatchNormalization", ["x", "s", "b", "mu", "var"], ["bn"], {"epsilon": 1e-3}),
        Node("InstanceNormalization", ["x", "s", "b"], ["inn"], {}),
        Node("LayerNormalization", ["x", "g", "be"], ["ln"], {"epsilon": 1e-6}),
        Node("LayerNormalization", ["x", "g2"], ["ln2"], {"axis": 1}),
    ]
    return graph(nodes, ["x"], ["bn", "inn", "ln", "ln2"], inits), {"x": f32(2, 3, 5)}


def case_matmul_gemm_softmax_einsum():
    inits = {"B": f32(6, 4), "C": f32(4), "Bt": f32(4, 6)}
    nodes = [
        Node("Gemm", ["A", "B", "C"], ["g1"], {"alpha": 0.5, "beta": 2.0}),
        Node("Gemm", ["At", "Bt"], ["g2"], {"transA": 1, "transB": 1}),
        Node("MatMul", ["x", "y"], ["mm"], {}),
        Node("Softmax", ["x"], ["sm"], {"axis": 1}),
        Node("Softmax", ["x"], ["sm_last"], {}),
        Node("Einsum", ["x", "y"], ["es"], {"equation": "bij,bjk->bik"}),
        Node("Einsum", ["x"], ["tr"], {"equation": "...ij->...ji"}),
    ]
    feeds = {"A": f32(3, 6), "At": f32(6, 3), "x": f32(2, 3, 5), "y": f32(2, 5, 4)}
    return graph(nodes, list(feeds), ["g1", "g2", "mm", "sm", "sm_last", "es", "tr"], inits), feeds


def case_shape_ops():
    inits = {"shp": i64(0, -1, 2), "sp": i64(1, 3), "ax0": i64(0), "reps": i64(2, 1, 3), "eshape": i64(2, 1, 3, 4)}
    nodes = [
        Node("Reshape", ["x", "shp"], ["rs"], {}),
        Node("Transpose", ["x"], ["tp"], {}),
        Node("Transpose", ["x"], ["tp2"], {"perm": [1, 0, 2]}),
        Node("Concat", ["x", "x"], ["cc"], {"axis": -1}),
        Node("Split", ["x", "sp"], ["sa", "sb"], {"axis": 1}),
        Node("Split", ["x"], ["sc", "sd"], {"axis": 2, "split": [1, 3]}),
        Node("Split", ["x"], ["se", "sf"], {"axis": 2}),
        Node("Flatten", ["x"], ["fl"], {"axis": 2}),
        Node("Flatten", ["x"], ["fl0"], {"axis": 0}),
        Node("Unsqueeze", ["x", "ax0"], ["un"], {}),
        Node("Unsqueeze", ["x"], ["un2"], {"axes": [1, -1]}),
        Node("Squeeze", ["un2"], ["sq"], {"axes": [1]}),
        Node("Squeeze", ["un"], ["sq_all"], {}),
        Node("Shape", ["x"], ["shape"], {}),
        Node("Size", ["x"], ["size"], {}),
        Node("Expand", ["v", "eshape"], ["ex"], {}),
        Node("Tile", ["x", "reps"], ["tl"], {}),
        Node("Identity", ["x"], ["id"], {}),
        Node("Dropout", ["x"], ["dr", "dmask"], {}),
    ]
    outs = ["rs", "tp", "tp2", "cc", "sa", "sb", "sc", "sd", "se", "sf", "fl", "fl0", "un", "un2", "sq", "sq_all",
            "shape", "size", "ex", "tl", "id", "dr", "dmask"]
    return graph(nodes, ["x", "v"], outs, inits), {"x": f32(2, 4, 4), "v": f32(3, 1)}


def case_slice():
    inits = {"s": i64(1, -1), "e": i64(100, -100), "a": i64(1, 2), "st": i64(2, -2),
             "s2": i64(-1), "e2": i64(-6), "a2": i64(0), "st2": i64(-1), "s3": i64(0, 1), "e3": i64(2, 3)}
    nodes = [
        Node("Slice", ["x", "s", "e", "a", "st"], ["pos_neg"], {}),
        Node("Slice", ["x", "s2", "e2", "a2", "st2"], ["rev"], {}),
        Node("Slice", ["x", "s3", "e3"], ["no_axes"], {}),
        Node("Slice", ["x"], ["attr"], {"starts": [1], "ends": [-1], "axes": [2]}),
    ]
    return graph(nodes, ["x"], ["pos_neg", "rev", "no_axes", "attr"], inits), {"x": f32(4, 5, 6)}


def case_gather_scatter_where_cast():
    inits = {"idx": np.asarray([[0, -1], [2, 1]], np.int64), "idx1": i64(3, 0, -2),
             "sidx": np.asarray([[0, 1], [2, 3]], np.int64), "upd": f32(2)}
    nodes = [
        Node("Gather", ["x", "idx"], ["g0"], {"axis": 0}),
        Node("Gather", ["x", "idx1"], ["g1"], {"axis": 1}),
        Node("ScatterND", ["x", "sidx", "upd"], ["sc"], {}),
        Node("Where", ["m", "x", "y"], ["wh"], {}),
        Node("Cast", ["x"], ["to_i32"], {"to": 6}),
        Node("Cast", ["x"], ["to_i64"], {"to": 7}),
        Node("Cast", ["x"], ["to_bool"], {"to": 9}),
        Node("Cast", ["x"], ["to_f16"], {"to": 10}),
        Node("Cast", ["m"], ["b_to_f"], {"to": 1}),
    ]
    x = f32(3, 4, lo=-5, hi=5)
    x[0, 0] = 0.0
    feeds = {"x": x, "y": f32(3, 4), "m": RNG.random((3, 4)) > 0.5}
    outs = ["g0", "g1", "sc", "wh", "to_i32", "to_i64", "to_bool", "to_f16", "b_to_f"]
    return graph(nodes, ["x", "y", "m"], outs, inits), feeds


def case_constants_range():
    nodes = [
        Node("Constant", [], ["c_t"], {"value": f32(2, 3)}),
        Node("Constant", [], ["c_f"], {"value_float": 1.25}),
        Node("Constant", [], ["c_i"], {"value_int": 7}),
        Node("Constant", [], ["c_fs"], {"value_floats": [1.5, -2.0]}),
        Node("Constant", [], ["c_is"], {"value_ints": [3, 1, 2]}),
        Node("ConstantOfShape", ["c_is"], ["cos_f"], {}),
        Node("ConstantOfShape", ["c_is"], ["cos_v"], {"value": np.asarray([4], np.int32)}),
        Node("Range", ["r0", "r1", "r2"], ["rng"], {}),
        Node("Add", ["c_t", "c_f"], ["c_sum"], {}),
    ]
    feeds = {"r0": np.int64(2), "r1": np.int64(11), "r2": np.int64(3)}
    outs = ["c_t", "c_f", "c_i", "c_fs", "c_is", "cos_f", "cos_v", "rng", "c_sum"]
    return graph(nodes, list(feeds), outs), feeds


def case_reduce_arg_cumsum():
    inits = {"axes": i64(0, 2), "cax": i64(1)}
    nodes = []
    outs = []
    for op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd"):
        nodes += [Node(op, ["x"], [op + "_attr"], {"axes": [1], "keepdims": 0}),
                  Node(op, ["x", "axes"], [op + "_in"], {}),
                  Node(op, ["x"], [op + "_all"], {"keepdims": 0})]
        outs += [op + "_attr", op + "_in", op + "_all"]
    nodes += [
        Node("ReduceSum", ["k"], ["isum"], {"axes": [0]}),
        Node("ReduceMean", ["k"], ["imean"], {}),
        Node("ArgMax", ["x"], ["amax"], {"axis": 1}),
        Node("ArgMin", ["x"], ["amin"], {"axis": -1, "keepdims": 0}),
        Node("CumSum", ["x", "cax"], ["cs"], {}),
        Node("CumSum", ["x", "cax"], ["csr"], {"reverse": 1}),
    ]
    outs += ["isum", "imean", "amax", "amin", "cs", "csr"]
    feeds = {"x": f32(2, 3, 4, lo=0.5, hi=1.5), "k": i64(3, -1, 4, 1, -5, 9).reshape(2, 3)}
    return graph(nodes, ["x", "k"], outs, inits), feeds


def case_activations():
    inits = {"lo": np.float32(-0.5), "hi": np.float32(0.75), "slope": f32(3, 1)}
    nodes = [
        Node("Clip", ["x", "lo", "hi"], ["clip"], {}),
        Node("Clip", ["x", "", "hi"], ["clip_hi"], {}),
        Node("Clip", ["x", "lo"], ["clip_lo"], {}),
        Node("Clip", ["x"], ["clip_attr"], {"min": -1.0, "max": 1.0}),
        Node("LeakyRelu", ["x"], ["lrelu"], {"alpha": 0.2}),
        Node("LeakyRelu", ["x"], ["lrelu_d"], {}),
        Node("PRelu", ["x", "slope"], ["prelu"], {}),
        Node("Elu", ["x"], ["elu"], {"alpha": 0.7}),
    ]
    return graph(nodes, ["x"], ["clip", "clip_hi", "clip_lo", "clip_attr", "lrelu", "lrelu_d", "prelu", "elu"],
                 inits), {"x": f32(2, 3, 4)}


def case_pool():
    nodes = [
        Node("AveragePool", ["x"], ["ap"], {"kernel_shape": [3, 2], "strides": [2, 1], "pads": [1, 0, 1, 1]}),
        Node("AveragePool", ["x"], ["ap_same"], {"kernel_shape": [3, 3], "auto_pad": "SAME_UPPER"}),
        Node("MaxPool", ["x"], ["mp"], {"kernel_shape": [2, 3], "strides": [2, 2], "pads": [0, 1, 1, 1]}),
        Node("GlobalAveragePool", ["x"], ["gap"], {}),
        Node("MaxPool", ["x1"], ["mp1"], {"kernel_shape": [3], "strides": [2]}),
        Node("AveragePool", ["x1"], ["ap1"], {"kernel_shape": [4], "pads": [2, 1]}),
    ]
    return graph(nodes, ["x", "x1"], ["ap", "ap_same", "mp", "gap", "mp1", "ap1"]), {"x": f32(2, 3, 7, 8),
                                                                                     "x1": f32(1, 2, 11)}


def case_pad():
    inits = {"pads": i64(0, 1, 2, 0, 2, 1), "cval": np.float32(-3.0), "pads4": i64(0, 0, 1, 2, 0, 0, 3, 1)}
    nodes = [
        Node("Pad", ["x", "pads", "cval"], ["const"], {}),
        Node("Pad", ["x", "pads"], ["const0"], {"mode": "constant"}),
        Node("Pad", ["x", "pads"], ["reflect"], {"mode": "reflect"}),
        Node("Pad", ["x", "pads"], ["edge"], {"mode": "edge"}),
        Node("Pad", ["x4", "pads4"], ["reflect4"], {"mode": "reflect"}),
        Node("Pad", ["x"], ["attr"], {"pads": [1, 0, 0, 0, 0, 2]}),
    ]
    return graph(nodes, ["x", "x4"], ["const", "const0", "reflect", "edge", "reflect4", "attr"], inits), {
        "x": f32(2, 4, 5), "x4": f32(1, 2, 5, 6)}


def case_resize():
    inits = {"up": np.asarray([1, 1, 2, 3], np.float32), "down": np.asarray([1, 1, 0.5, 0.4], np.float32),
             "sizes": i64(1, 2, 5, 7), "empty": np.zeros(0, np.float32)}
    nodes = []
    outs = []
    for mode in ("nearest", "linear", "cubic"):
        nodes += [Node("Resize", ["x", "", "up"], [mode + "_up"], {"mode": mode}),
                  Node("Resize", ["x", "", "down"], [mode + "_down"], {"mode": mode}),
                  Node("Resize", ["x", "", "empty", "sizes"], [mode + "_sizes"], {"mode": mode})]
        outs += [mode + "_up", mode + "_down", mode + "_sizes"]
    return graph(nodes, ["x"], outs, inits), {"x": f32(1, 2, 8, 10)}


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("family", sorted(CASES))
def test_op_family_matches_onnx_lite(family):
    g, feeds = CASES[family]()
    run_both(g, feeds)


def test_every_op_is_covered():
    """The cases reach every op the JAX executor handles."""
    import inspect
    import re

    src = inspect.getsource(jol.OnnxModel._exec)
    handled = set(re.findall(r'op == "(\w+)"', src)) | set(jol._ELEMENTWISE) | set(jol._BINARY)
    for tup in re.findall(r"op in \(([^)]*)\)", src):
        handled |= set(re.findall(r'"(\w+)"', tup))
    covered = {n.op_type for fn in CASES.values() for n in fn()[0].nodes}
    assert handled - covered == set()
    assert set(pol._ELEMENTWISE) == set(jol._ELEMENTWISE) and set(pol._BINARY) == set(jol._BINARY)


def test_unknown_op_raises():
    g = graph([Node("NoSuchOp", ["x"], ["y"], {})], ["x"], ["y"])
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        OnnxModel(encode_model(g), device="cpu").run({"x": f32(2)})


def test_wire_format_round_trips_between_packages():
    g = Graph(
        nodes=[Node("Conv", ["x", "w"], ["y"], {"strides": [2], "pads": [1, 1], "alpha": 0.5, "mode": "reflect",
                                                "scales": [1.0, 2.0], "t": f32(2, 2)}, name="n0"),
               Node("Relu", ["y"], ["out"], {})],
        initializers={"w": f32(3, 2, 4), "i": i64(1, -2, 3), "h": f32(2).astype(np.float16)},
        inputs=["x"], outputs=["out"], name="g",
        io_types={"x": (np.dtype(np.float32), (1, 2, -1)), "out": (np.dtype(np.float32), (1, 3, -1))},
    )
    jg = jol.Graph(nodes=[jol.Node(n.op_type, n.inputs, n.outputs, n.attrs, n.name) for n in g.nodes],
                   initializers=g.initializers, inputs=g.inputs, outputs=g.outputs, name=g.name, io_types=g.io_types)
    data = encode_model(g)
    assert data == jol.encode_model(jg)  # the two writers emit the same bytes
    for parsed in (parse_model(data), jol.parse_model(data)):
        assert [(n.op_type, n.inputs, n.outputs, n.name) for n in parsed.nodes] == \
            [(n.op_type, n.inputs, n.outputs, n.name) for n in g.nodes]
        assert parsed.nodes[0].attrs["strides"] == [2] and parsed.nodes[0].attrs["mode"] == b"reflect"
        np.testing.assert_array_equal(parsed.nodes[0].attrs["t"], g.nodes[0].attrs["t"])
        for k, v in g.initializers.items():
            assert parsed.initializers[k].dtype == v.dtype
            np.testing.assert_array_equal(parsed.initializers[k], v)
        assert parsed.inputs == ["x"] and parsed.outputs == ["out"] and parsed.io_types == g.io_types


def test_conv_stack_graph():
    """tests/test_onnx_lite.py's conv stack on both executors and torch."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(2, 4, 3, stride=2, padding=1)
    bn = torch.nn.BatchNorm2d(4)
    bn.running_mean.data.uniform_(-0.2, 0.2)
    bn.running_var.data.uniform_(0.5, 1.5)
    bn.eval()
    convt = torch.nn.ConvTranspose2d(4, 3, 4, stride=2, padding=1)
    x = torch.randn(1, 2, 12, 16)
    with torch.no_grad():
        want = F.avg_pool2d(convt(F.relu(bn(conv(x)))), 2, 2)
    g = Graph(
        nodes=[
            Node("Conv", ["x", "cw", "cb"], ["h1"], {"strides": [2, 2], "pads": [1, 1, 1, 1]}),
            Node("BatchNormalization", ["h1", "bns", "bnb", "bnm", "bnv"], ["h2"], {"epsilon": 1e-5}),
            Node("Relu", ["h2"], ["h3"], {}),
            Node("ConvTranspose", ["h3", "tw", "tb"], ["h4"], {"strides": [2, 2], "pads": [1, 1, 1, 1]}),
            Node("AveragePool", ["h4"], ["out"], {"kernel_shape": [2, 2], "strides": [2, 2]}),
        ],
        initializers={
            "cw": conv.weight.detach().numpy(), "cb": conv.bias.detach().numpy(),
            "bns": bn.weight.detach().numpy(), "bnb": bn.bias.detach().numpy(),
            "bnm": bn.running_mean.numpy(), "bnv": bn.running_var.numpy(),
            "tw": convt.weight.detach().numpy(), "tb": convt.bias.detach().numpy(),
        },
        inputs=["x"], outputs=["out"],
    )
    ((out, _),) = run_both(g, {"x": x.numpy()})
    np.testing.assert_allclose(out, want.numpy(), atol=1e-5)


def test_bert_block_graph():
    """tests/test_onnx_lite.py's BERT block (embedding gather, decomposed
    LayerNorm, attention, erf-GELU) on both executors and torch."""
    rng = np.random.default_rng(1)
    V, D, T = 11, 16, 5
    emb = rng.standard_normal((V, D)).astype(np.float32)
    wq = rng.standard_normal((D, D)).astype(np.float32)
    gamma = rng.standard_normal(D).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32)
    ids = rng.integers(0, V, (2, T)).astype(np.int64)
    g = Graph(
        nodes=[
            Node("Gather", ["emb", "ids"], ["e"], {"axis": 0}),
            Node("ReduceMean", ["e"], ["mu"], {"axes": [-1], "keepdims": 1}),
            Node("Sub", ["e", "mu"], ["c"], {}),
            Node("Pow", ["c", "two"], ["c2"], {}),
            Node("ReduceMean", ["c2"], ["var"], {"axes": [-1], "keepdims": 1}),
            Node("Add", ["var", "eps"], ["ve"], {}),
            Node("Sqrt", ["ve"], ["sd"], {}),
            Node("Div", ["c", "sd"], ["nrm"], {}),
            Node("Mul", ["nrm", "gamma"], ["sg"], {}),
            Node("Add", ["sg", "beta"], ["ln"], {}),
            Node("MatMul", ["ln", "wq"], ["q"], {}),
            Node("Transpose", ["ln"], ["lnT"], {"perm": [0, 2, 1]}),
            Node("MatMul", ["q", "lnT"], ["scores"], {}),
            Node("Softmax", ["scores"], ["attn"], {"axis": -1}),
            Node("MatMul", ["attn", "ln"], ["ctx"], {}),
            Node("Div", ["ctx", "sqrt2"], ["g1"], {}),
            Node("Erf", ["g1"], ["g2"], {}),
            Node("Add", ["g2", "one"], ["g3"], {}),
            Node("Mul", ["ctx", "g3"], ["g4"], {}),
            Node("Mul", ["g4", "half"], ["out"], {}),
        ],
        initializers={
            "emb": emb, "wq": wq, "gamma": gamma, "beta": beta, "two": np.float32(2.0), "eps": np.float32(1e-5),
            "sqrt2": np.float32(np.sqrt(2.0)), "one": np.float32(1.0), "half": np.float32(0.5),
        },
        inputs=["ids"], outputs=["out"],
    )
    ((out, _),) = run_both(g, {"ids": ids})
    e = torch.from_numpy(emb)[torch.from_numpy(ids)]
    ln = F.layer_norm(e, (D,), torch.from_numpy(gamma), torch.from_numpy(beta))
    attn = torch.softmax((ln @ torch.from_numpy(wq)) @ ln.transpose(1, 2), dim=-1)
    np.testing.assert_allclose(out, F.gelu(attn @ ln, approximate="none").numpy(), atol=1e-5)


def test_device_default_is_cuda():
    """device=None means the card; without one the executor raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g, _ = case_activations()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnnxModel(encode_model(g))
