"""Every kernel wrapper (K1-K6) refuses, before any launch, an input that
requires a gradient while grad mode is on: the CUDA kernels have no
backward, so their outputs would carry no grad_fn and training upstream of
them would silently stop. The wrappers take the kernel only for a CUDA
tensor, so these CPU tests patch each wrapper's device test to say "card":
the refusal must come first, before the library is loaded; without a
gradient (or under no_grad) the wrapper goes on towards its launch, which
fails here (no card, no nvcc)."""

import pytest
import torch

from gpt_sovits_tpu_torch.ops import decode_step as ds
from gpt_sovits_tpu_torch.ops import qflash as qf
from gpt_sovits_tpu_torch.ops import qmatmul as qm
from gpt_sovits_tpu_torch.ops import snake_aa as sa

REFUSED = "no backward"


def _k2(grad):
    x = torch.randn(1, 8, 128).to(torch.bfloat16).requires_grad_(grad)
    return lambda: qm.qdense_int8(x, torch.zeros(128, 128, dtype=torch.int8), torch.ones(128), torch.zeros(128))


def _k3(grad):
    x = torch.randn(1, 8, 128).to(torch.bfloat16).requires_grad_(grad)
    w = torch.zeros(128, 128, dtype=torch.int8)
    s, b = torch.ones(128), torch.zeros(128)
    return lambda: qm.qkv_rope_int8(x, w, w, w, s, s, s, b, b, b, dim_head=64)


def _k4(grad):
    a = torch.randn(1, 2, 8, 64).to(torch.bfloat16).requires_grad_(grad)
    return lambda: qm.qdense_out_int8(a, torch.zeros(128, 128, dtype=torch.int8), torch.ones(128), torch.zeros(128))


def _k5(grad):
    q, k, v = (torch.randn(1, 2, 8, 64).to(torch.bfloat16).requires_grad_(grad) for _ in range(3))
    return lambda: qf.flash_attn_int8(q, k, v, torch.ones(1, 8), sm_scale=0.125)


def _k6(grad):
    x = torch.randn(1, 4, 32)
    alpha = torch.zeros(4, requires_grad=grad)  # a BigVGAN parameter
    return lambda: sa.snake_aa(x, alpha, torch.zeros(4))


def _k1(grad):
    x = torch.randn(1, 512, requires_grad=grad)
    kv = torch.zeros(1, 1, 16, 1024, dtype=torch.bfloat16)
    return lambda: ds.fused_decode_step(x, {}, kv, torch.ones(1, 16), 3)


CASES = {"K1": (_k1, ds, "_route"), "K2": (_k2, qm, "on_card"), "K3": (_k3, qm, "on_card"),
         "K4": (_k4, qm, "on_card"), "K5": (_k5, qf, "on_card"), "K6": (_k6, sa, "on_card")}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_wrapper_refuses_a_gradient_before_the_launch(kernel, monkeypatch):
    make, mod, device_test = CASES[kernel]
    monkeypatch.setattr(mod, device_test, lambda t: True)
    launched = []
    monkeypatch.setattr(mod, "_lib", lambda: launched.append(1) or (_ for _ in ()).throw(RuntimeError("launch")))
    with pytest.raises(RuntimeError, match=REFUSED):
        make(True)()
    assert not launched
    # without a gradient, or with grad mode off, the wrapper goes on towards
    # its launch (and fails there: no card, no nvcc, or K1's own checks)
    with pytest.raises(Exception) as err:
        make(False)()
    assert REFUSED not in str(err.value)
    with torch.no_grad(), pytest.raises(Exception) as err:
        make(True)()
    assert REFUSED not in str(err.value)


def test_cpu_tensors_keep_the_differentiable_twin():
    x = torch.randn(1, 4, 32, requires_grad=True)
    alpha = torch.zeros(4, requires_grad=True)
    y = sa.snake_aa(x, alpha, torch.zeros(4))
    y.sum().backward()
    assert x.grad is not None and alpha.grad is not None
