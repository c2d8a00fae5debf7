"""The port's ONNX export (gpt_sovits_tpu_torch/utils/onnx_export.py: a
torch.export program lowered ATen op by ATen op) against the JAX package's
(gpt_sovits_tpu/utils/onnx_export.py: a jaxpr lowered primitive by
primitive) on the CPU, at the JAX tests' tiny configs, with weights drawn
with numpy and carried across by weights.py.

The graphs run through the port's executor (utils/onnx_lite.py OnnxModel,
device="cpu"). Each port graph is held against the JAX model's direct apply
at tests/test_onnx_export.py's tolerances (1e-6 for the basics, 1e-4 for
the grouped transposed convolution, 2e-4 for the models), and the JAX
package's ONNX file for the same module, run through the same executor,
against the port's. The counterparts of the JAX basics: slices at a traced
position, the flipped grouped transposed convolution, I/O types and
duplicate outputs, `fmod`'s C semantics, refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpt_sovits_tpu.models.bigvgan import BigVGAN as JBigVGAN, BigVGANConfig as JBigVGANConfig
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.utils import onnx_export as joe
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.utils import onnx_export as oe
from gpt_sovits_tpu_torch.utils.onnx_lite import OnnxModel, parse_model

from test_t2s import TINY as S1_TINY
from test_torch_export import BIGVGAN_TINY, drawn_vocoder, japply, s1, s1_step_inputs, s2, s2_jax_decode  # noqa: F401

torch.set_num_threads(1)
MODEL_ATOL = 2e-4  # tests/test_onnx_export.py's


def run(blob: bytes, *args) -> list:
    m = OnnxModel(blob, device="cpu")
    return [t.numpy() for t in m.run(dict(zip(m.input_names, args)))]


def test_to_onnx_basics():
    fn = lambda x, w: torch.tanh(x @ w) * torch.sigmoid(x @ w)  # noqa: E731
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4).astype(np.float32))
    w = torch.from_numpy((np.random.RandomState(1).randn(4, 3) * 0.1).astype(np.float32))
    np.testing.assert_allclose(run(oe.to_onnx(fn, (x, w)), x, w)[0], fn(x, w).numpy(), atol=1e-6)


def test_to_onnx_dynamic_slices():
    """A write and a read of 3 rows at a position known only at run time."""

    def fn(cache, upd, i):
        idx = i + torch.arange(3)
        return cache.index_copy(1, idx, upd).index_select(1, idx)

    cache = torch.zeros((2, 10, 4))
    upd = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 4).astype(np.float32))
    blob = oe.to_onnx(fn, (cache, upd, torch.tensor(5)))
    for i in (5, 2, 7):
        np.testing.assert_allclose(run(blob, cache, upd, np.asarray(i))[0], fn(cache, upd, torch.tensor(i)).numpy(),
                                   atol=1e-6)


def test_to_onnx_flip_and_grouped_conv_transpose():
    def fg(x, w):
        return torch.flip(F.conv_transpose1d(x, w, stride=2, padding=1, groups=4), dims=(2,))

    x = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 16).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).randn(8, 2, 5).astype(np.float32))
    np.testing.assert_allclose(run(oe.to_onnx(fg, (x, w)), x, w)[0], fg(x, w).numpy(), atol=1e-4)


def test_s2_decode_onnx_parity(s2):  # noqa: F811
    jm, params, pm, args = s2
    got = run(oe.export_s2_decode_onnx(pm, b=1, tc=12, tt=8, tr=16), *args)
    np.testing.assert_allclose(got[0], s2_jax_decode(), atol=MODEL_ATOL)
    jax_file = run(joe.export_s2_decode_onnx(jm, params, b=1, tc=12, tt=8, tr=16), *args)
    np.testing.assert_allclose(got[0], jax_file[0], atol=MODEL_ATOL)


def test_s1_step_and_prefill_onnx_parity(s1):  # noqa: F811
    jm, params, pm = s1
    t, slot = 64, 10
    e, k, v, valid = s1_step_inputs(S1_TINY, 1, t, slot, 1)
    step_args = (e, k, v, valid, np.asarray(slot, np.int32))
    got = run(oe.export_s1_step_onnx(pm, b=1, t_cache=t), *step_args)
    want = japply(jm, params, *step_args, method=JT2S.decode_step)
    jax_file = run(joe.export_s1_step_onnx(jm, params, b=1, t_cache=t), *step_args)
    for g, w, jf in zip(got, want, jax_file):
        np.testing.assert_allclose(g, np.asarray(w), atol=MODEL_ATOL)
        np.testing.assert_allclose(g, jf, atol=MODEL_ATOL)
    np.testing.assert_array_equal(np.delete(got[1], slot, axis=2), np.delete(k, slot, axis=2))

    n = 12
    rng = np.random.default_rng(2)
    xy = (rng.standard_normal((1, n, S1_TINY.embedding_dim)) * 0.1).astype(np.float32)
    bias = np.where(np.tril(np.ones((n, n), bool))[None, None], 0.0, -1e9).astype(np.float32)
    got = run(oe.export_s1_prefill_onnx(pm, b=1, t=n), xy, bias)
    want = japply(jm, params, xy, bias, method=JT2S.prefill)
    jax_file = run(joe.export_s1_prefill_onnx(jm, params, b=1, t=n), xy, bias)
    for g, w, jf in zip(got, want, jax_file):
        np.testing.assert_allclose(g, np.asarray(w), atol=MODEL_ATOL)
        np.testing.assert_allclose(g, jf, atol=MODEL_ATOL)


def test_vocoder_onnx_parity():
    jm = JBigVGAN(JBigVGANConfig(**BIGVGAN_TINY))
    mel = (np.random.default_rng(2).standard_normal((1, 20, BIGVGAN_TINY["num_mels"])) * 0.5).astype(np.float32)
    params = drawn_vocoder(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(mel)), 8)
    pm = BigVGAN(BigVGANConfig(**BIGVGAN_TINY))
    pm.load_state_dict(weights.bigvgan_from_jax(params, pm.cfg))
    got = run(oe.export_vocoder_onnx(pm.eval(), b=1, t=20), mel)[0]
    want = np.asarray(japply(jm, params, mel))
    assert np.abs(want).max() < 0.99  # not clamped
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
    np.testing.assert_allclose(got, run(joe.export_vocoder_onnx(jm, params, b=1, t=20), mel)[0], atol=MODEL_ATOL)


def test_to_onnx_io_types_and_dup_outputs():
    def fn(x, i):
        y = torch.tanh(x)
        return y, y, x.to(torch.int32) + i  # the same value twice, mixed dtypes

    x = torch.from_numpy(np.random.RandomState(0).randn(2, 5).astype(np.float32))
    blob = oe.to_onnx(fn, (x, torch.tensor(3, dtype=torch.int32)))
    g = parse_model(blob)
    assert len(set(g.outputs)) == len(g.outputs) == 3
    for name in g.inputs + g.outputs:
        assert name in g.io_types, f"missing TypeProto for {name}"
    assert g.io_types[g.inputs[0]] == (np.dtype(np.float32), (2, 5))
    assert g.io_types[g.outputs[0]] == (np.dtype(np.float32), (2, 5))
    assert g.io_types[g.outputs[2]][0] == np.dtype(np.int32)
    o = run(blob, x, np.asarray(3, np.int32))
    np.testing.assert_allclose(o[0], np.tanh(x.numpy()), atol=1e-6)
    np.testing.assert_array_equal(o[0], o[1])
    np.testing.assert_array_equal(o[2], x.numpy().astype(np.int32) + 3)


def test_to_onnx_rem_c_semantics():
    """torch.fmod follows the dividend's sign (Mod fmod=1); torch.remainder
    and integer floor division follow the divisor's, as the ONNX
    specification reads them and as the executor runs them."""

    def fn(a, b):
        ai, bi = a.to(torch.int32), b.to(torch.int32)
        return torch.fmod(a, b), torch.fmod(ai, bi), torch.remainder(a, b), torch.remainder(ai, bi), ai // bi

    a = torch.tensor([-7.5, 7.5, -3.0, 3.0, -7.0])
    b = torch.tensor([2.0, -2.0, 2.5, -2.5, 2.0])
    blob = oe.to_onnx(fn, (a, b))
    for got, want in zip(run(blob, a, b), fn(a, b)):
        np.testing.assert_allclose(got, want.numpy(), atol=1e-6)


def test_unknown_and_unsupported_ops_refused():
    with pytest.raises(NotImplementedError, match="aten.cummax"):
        oe.to_onnx(lambda x: torch.cummax(x, 0)[0] * 2, (torch.randn(4, 3),))
    # advanced indexing with two index tensors (no Gather form): refused
    # instead of exported with a wrong element order
    with pytest.raises(NotImplementedError, match="aten.index.Tensor"):
        oe.to_onnx(lambda t, i, j: t[i, j] * 2, (torch.randn(6, 4), torch.tensor([1, 3]), torch.tensor([0, 2])))
