"""Operations and bytes of BigVGAN-v2 (x256); `c` is a configuration file's
"vocoder" object (num_mels, upsample_rates, upsample_kernel_sizes,
upsample_initial_channel, resblock_kernel_sizes, resblock_dilation_sizes).

A call on a (rows, frames, mels) mel: the 7-tap input convolution, six
transposed convolutions, after each the AMP blocks (two convolutions and
two anti-aliased snakes a dilation, each snake one K6 launch), a last K6
launch and the 7-tap output convolution. Convolutions count their
multiply-accumulates (a transposed one every input sample times every
output channel and tap, as flops/vits.py counts HiFiGAN's); a K6 launch
the bytes it must move: its input read and its output written once, and
its per-channel alpha and beta (f32). The x2 resampling filters inside
K6 and the blocks' sums are left out (a lower bound).
"""

from __future__ import annotations

ELEMENT_BYTES = 2  # the activations K6 reads and writes: bf16, as the configuration states
PARAM_BYTES = 4  # alpha and beta are f32 whatever the activations' dtype


def stages(c: dict, frames: int) -> list:
    """(channels, samples) of each stage: after each transposed convolution."""
    uic, t, out = c["upsample_initial_channel"], frames, []
    for i, u in enumerate(c["upsample_rates"]):
        t *= u
        out.append((uic // 2 ** (i + 1), t))
    return out


def conv_macs(c: dict, frames: int) -> dict:
    """Multiply-accumulates of one row's convolutions by part: "pre" (the
    input convolution), "up0" (the first transposed convolution), "inner"
    (the other transposed convolutions and every AMP block's convolutions:
    the work between a call's first K6 launch and its last) and "post"
    (the output convolution)."""
    uic = c["upsample_initial_channel"]
    ups, blocks, t = [], 0, frames
    for i, ((ch, t_out), k) in enumerate(zip(stages(c, frames), c["upsample_kernel_sizes"])):
        ups.append(t * (uic // 2**i) * ch * k)
        t = t_out
        blocks += sum(2 * len(d) * t * ch * ch * rk for rk, d in zip(c["resblock_kernel_sizes"],
                                                                    c["resblock_dilation_sizes"]))
    ch, t = stages(c, frames)[-1]
    return {"pre": frames * c["num_mels"] * uic * 7, "up0": ups[0], "inner": sum(ups[1:]) + blocks,
            "post": t * ch * 7}


def k6_launches(c: dict, frames: int) -> list:
    """(channels, samples) of each K6 launch of one call, in launch order."""
    per_stage = 2 * sum(len(d) for d in c["resblock_dilation_sizes"])
    out = [s for s in stages(c, frames) for _ in range(per_stage)]
    return out + [out[-1]]


def k6_bytes(channels: int, samples: int, rows: int = 1) -> int:
    """Bytes one K6 launch on (rows, channels, samples) must move."""
    return 2 * rows * channels * samples * ELEMENT_BYTES + 2 * channels * PARAM_BYTES


def call(c: dict, frames: int, rows: int = 1) -> dict:
    """One call's convolution operations by part (2 a multiply-accumulate,
    all rows) and its K6 launches' bytes."""
    return {"ops": {k: 2 * rows * v for k, v in conv_macs(c, frames).items()},
            "k6_bytes": sum(k6_bytes(ch, t, rows) for ch, t in k6_launches(c, frames))}
