"""Model export for external runtimes (port of gpt_sovits_tpu/utils/export.py).

The JAX package serializes StableHLO with `jax.export`. The port's artifact
is a `torch.export` program written by `torch.export.save` ("pt2"): the
graph and its weights in one archive, which `torch.export.load` runs
without the model code. Shapes are fixed at the example inputs, as in the
JAX export.

The same graph split as the JAX package (and the reference's export
scripts): the S1 decode step, S2 decode (codes + reference -> waveform),
the vocoder (mel -> waveform), and for v3/v4 `decode_encp` and the CFM
Euler loop. Every exporter traces a plain composition, as the JAX exports
trace no Pallas kernel: the S1 step is `decode_step_functional` (JAX's
`decode_step`, not the fused K1 step), BigVGAN is rebuilt with
`use_kernel=False` (JAX's `use_pallas=False`), and the DiT is the float one
(JAX's default `quant="bf16"`). A kernel wrapper reached while tracing on a
card raises (ops/qmatmul.py `refuse_trace`).

Differences by design: the CFM artifact takes the initial noise (b, t, mel)
f32 as its fourth input where JAX's takes a seed, since a torch program
cannot carry a seeded generator; `SynthesizerTrn.decode` takes its prior
noise as a tensor for the same reason.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Callable, Sequence

import torch
import torch.nn as nn

from gpt_sovits_tpu_torch import resolve_device


class _Call(nn.Module):
    """A module whose forward is `module.<method>(*args, **kw)`."""

    def __init__(self, module: nn.Module, method: str = "forward", **kw):
        super().__init__()
        self.m = module
        self.method = method
        self.kw = kw

    def forward(self, *args):
        return getattr(self.m, self.method)(*args, **self.kw)


class _Fn(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def subset(model: nn.Module, keep: Sequence[str]) -> nn.Module:
    """A shallow copy of `model` holding only its submodules named in `keep`
    (sharing their weights): the export of one of its methods then carries
    only the weights that method reads, since torch.export keeps every
    parameter of the module it is given."""
    part = copy.copy(model)
    object.__setattr__(part, "_modules", {k: v for k, v in model._modules.items() if k in keep})
    return part


def export_program(fn_or_module, example_args: Sequence[Any]) -> torch.export.ExportedProgram:
    """torch.export (non-strict, no autograd) of a module or a function at
    fixed example shapes."""
    module = fn_or_module if isinstance(fn_or_module, nn.Module) else _Fn(fn_or_module)
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args), strict=False)


def export_fn(fn_or_module, example_args: Sequence[Any]) -> bytes:
    """export_program serialized with torch.export.save -> the pt2 bytes,
    without the example inputs (which save would store: for the S1 step, its
    two caches, 200 MB at full width)."""
    ep = export_program(fn_or_module, example_args)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_exported(blob: bytes, device=None) -> Callable:
    """Deserialize a pt2 artifact into a callable on `device` (the card
    unless the caller asks for the CPU). Arguments go to that device; they
    must have the example inputs' shapes and dtypes."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    module = move_to_device_pass(torch.export.load(io.BytesIO(blob)), dev).module()

    def call(*args):
        with torch.no_grad():
            return module(*(torch.as_tensor(a).to(dev) for a in args))

    return call


# ---------------------------------------------------------------------------
# Model-specific exporters
# ---------------------------------------------------------------------------


def _first_param(model: nn.Module) -> torch.Tensor:
    return next(model.parameters())


def _s2_args(model, b: int, tc: int, tt: int, tr: int) -> tuple:
    """Codes, text and a reference of full lengths at the bucket shapes, on
    the model's device (int32 ids, as the JAX exports take)."""
    dev = _first_param(model).device
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.zeros((b, tc), **i32), torch.full((b,), tc, **i32), torch.zeros((b, tt), **i32),
            torch.full((b,), tt, **i32), torch.zeros((b, tr, model.cfg.spec_channels), device=dev),
            torch.full((b,), tr, **i32))


def s2_decode_module(model) -> nn.Module:
    """SynthesizerTrn.decode without the training-only weights (ssl_proj,
    the posterior encoder)."""
    return _Call(subset(model, [k for k in model._modules if k not in ("ssl_proj", "enc_q")]), "decode")


def export_s2_decode(model, *, b=1, tc=256, tt=128, tr=256) -> bytes:
    """SynthesizerTrn.decode at fixed bucket shapes, without prior noise (the
    JAX export's noise_rng=None): (codes, codes_lengths, text, text_lengths,
    refer_spec, refer_lengths) -> waveform (b, T_wav, 1). No kernel: the S2
    decode has none."""
    return export_fn(s2_decode_module(model), _s2_args(model, b, tc, tt, tr))


def s1_step_args(model, b: int, t_cache: int) -> tuple:
    c = model.cfg
    p = _first_param(model)
    h, dh = c.num_heads, c.hidden_dim // c.num_heads
    cache = torch.zeros((c.num_layers, b, t_cache, h, dh), dtype=p.dtype, device=p.device)
    return (torch.zeros((b, 1, c.embedding_dim), dtype=p.dtype, device=p.device), cache, cache.clone(),
            torch.zeros((b, t_cache), dtype=torch.bool, device=p.device),
            torch.tensor(0, dtype=torch.int32, device=p.device))


def s1_step_module(model) -> nn.Module:
    return _Call(subset(model, ("h", "ar_predict_layer")), "decode_step_functional")


def export_s1_step(model, *, b=1, t_cache=2048) -> bytes:
    """One KV-cached S1 decode step, T2SDecoder.decode_step_functional (the
    plain step, not K1): (tok_emb (b,1,D), k_caches, v_caches (L,b,T,H,Dh),
    valid (b,T) bool, write_idx 0-d int32) -> (logits (b,V), new k_caches,
    new v_caches), the new K/V at write_idx."""
    return export_fn(s1_step_module(model), s1_step_args(model, b, t_cache))


def plain_vocoder(model) -> nn.Module:
    """The vocoder as the export traces it: a BigVGAN rebuilt with
    use_kernel=False on the same weights (its snakes through the plain
    composition, not K6); the v4 Generator as it is (it has no kernel)."""
    from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN

    if not isinstance(model, BigVGAN):
        return model
    with torch.device("meta"):
        plain = BigVGAN(model.cfg, use_kernel=False)
    plain.load_state_dict(model.state_dict(), assign=True)
    return plain.eval()


def vocoder_args(model, b: int, t: int) -> tuple:
    """A (b, t, mel) input, mel the vocoder's input channels."""
    p = _first_param(model)
    return (torch.zeros((b, t, model.conv_pre.in_channels), dtype=p.dtype, device=p.device),)


def export_vocoder(model, *, b=1, t=512) -> bytes:
    """BigVGAN / the v4 Generator: (b, t, mel) -> waveform, through
    plain_vocoder."""
    return export_fn(plain_vocoder(model), vocoder_args(model, b, t))


def export_v3_decode(model, *, b=1, tc=256, tt=128, tr=256) -> bytes:
    """SynthesizerTrnV3.decode_encp at fixed bucket shapes (the v3/v4 front
    half of the reference's export_torch_script_v3v4.py): codes + reference
    -> (DiT conditioning fea, ge, mel_len). The DiT's weights are left out;
    no kernel runs here."""
    keep = [k for k in model._modules if k != "cfm"]
    return export_fn(_Call(subset(model, keep), "decode_encp"), _s2_args(model, b, tc, tt, tr))


def export_cfm(model, *, b=1, t=512, tp=128, n_steps=8) -> bytes:
    """The whole CFM Euler loop (n_steps DiT forwards, unrolled) as one
    program: (fea (b,t,512), x_lens (b,) int32, prompt_mel (b,tp,mel),
    noise (b,t,mel) f32) -> mel (b,t,mel). The model's own float DiT (an
    int8 serving DiT, whose matmuls are K2-K5, is refused)."""
    from gpt_sovits_tpu_torch.models.v3 import cfm_inference

    dit = model.cfm.estimator
    if dit.cfg.quant != "bf16":
        raise ValueError(f"export_cfm exports the float DiT; this one is quantized ({dit.cfg.quant!r})")
    p = _first_param(dit)
    mel_dim, text_dim = dit.cfg.mel_dim, dit.cfg.text_dim

    def fn(mu, x_lens, prompt, noise):
        return cfm_inference(dit, mu, x_lens, prompt, noise=noise, n_steps=n_steps)

    loop = _Fn(fn)
    loop.dit = dit  # its weights as the program's parameters
    args = (torch.zeros((b, t, text_dim), dtype=p.dtype, device=p.device),
            torch.full((b,), t, dtype=torch.int32, device=p.device),
            torch.zeros((b, tp, mel_dim), dtype=p.dtype, device=p.device),
            torch.zeros((b, t, mel_dim), device=p.device))
    return export_fn(loop, args)
