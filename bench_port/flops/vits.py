"""Operations of the VITS parts: S2's text encoder with MRTE, the flow, the
v4 conditioning (`encp`) and the HiFiGAN generator. `c` is a configuration
file's "s2" (or "vocoder") object. Multiply-accumulates of the
convolutions and matmuls count 2 operations; normalisation, activations
and the relative-position terms are left out (a lower bound)."""

from __future__ import annotations


def _encoder(c: dict, layers: int, t: int) -> int:
    """MACs of the attention encoder (1x1 projections, scores and values, the
    k-wide FFN) over t frames."""
    h, f, k = c["hidden_channels"], c["filter_channels"], c["kernel_size"]
    return layers * (t * (4 * h * h + 2 * k * h * f) + 2 * t * t * h)


def _wn(hidden: int, k: int, layers: int, t: int) -> int:
    return layers * t * hidden * 2 * hidden * k + (layers - 1) * t * hidden * 2 * hidden + t * hidden * hidden


def text_encoder(c: dict, t: int, m: int) -> int:
    """MACs of the text encoder over t SSL frames (50 Hz) and m phones."""
    h, n, w = c["hidden_channels"], c["n_layers"], c["mrte_hidden"]
    macs = t * c["ssl_dim"] * h + _encoder(c, n // 2, t) + _encoder(c, n, m) + _encoder(c, n // 2, t)
    macs += t * h * w + m * h * w + t * w * w + 2 * m * w * w + t * w * w + 2 * t * m * w + t * w * h
    return macs + t * h * 2 * c["inter_channels"]


def flow(c: dict, t: int) -> int:
    """MACs of the four mean-only couplings over t frames."""
    half, h = c["inter_channels"] // 2, c["hidden_channels"]
    return 4 * (t * half * h + _wn(h, 5, 4, t) + t * h * half)


def s2_decode(c: dict, n_tokens: int, m: int) -> int:
    """Operations of decode_latent for n semantic tokens and m phones."""
    t = 2 * n_tokens
    return 2 * (text_encoder(c, t, m) + flow(c, t))


def encp(c: dict, n_tokens: int, m: int) -> int:
    """Operations of v4's decode_encp: the text encoder, the bridge and the
    WN encoder over the 4n mel frames."""
    t, frames = 2 * n_tokens, 4 * n_tokens
    return 2 * (text_encoder(c, t, m) + t * c["hidden_channels"] * 512 + frames * 512 * 512 * 2 + _wn(512, 5, 8, frames))


def generator(c: dict, frames: int, in_channels: int) -> int:
    """Operations of the HiFiGAN generator on `frames` input frames."""
    uic = c["upsample_initial_channel"]
    macs = frames * in_channels * uic * 7
    t, ch = frames, uic
    for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
        cin, ch = uic // 2**i, uic // 2 ** (i + 1)
        macs += t * cin * ch * k
        t *= u
        macs += sum(2 * len(d) * t * ch * ch * rk for rk, d in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]))
    return 2 * (macs + t * ch * 7)
