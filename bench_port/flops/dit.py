"""Operations and bytes of the v4 CFM's DiT; `c` is a configuration file's
"s2" object (cfm_dit_dim, cfm_dit_depth, cfm_dit_heads; heads of 64, the
FFN twice the width, mel 100, text 512)."""

from __future__ import annotations

DIM_HEAD = 64
FF_MULT = 2


def _dims(c: dict) -> tuple[int, int, int]:
    d = c["cfm_dit_dim"]
    return d, c["cfm_dit_heads"] * DIM_HEAD, d * FF_MULT


def block_macs(c: dict) -> int:
    """Weight multiply-accumulates of one block for one frame: q, k, v, out
    and the two FFN matrices (the six int8 matmuls)."""
    d, inner, f = _dims(c)
    return 3 * d * inner + inner * d + d * f + f * d


def block(c: dict, rows: int, t: int) -> tuple[int, int]:
    """(operations, bytes) of one block on `rows` chunks of `t` frames, every
    frame real: the six matmuls at int8 and attention (QK and PV) over the t
    keys; bytes: the int8 weights with their f32 scales and biases once, the
    block's bf16 input read and output written once."""
    d, inner, f = _dims(c)
    ops = rows * (2 * t * block_macs(c) + 4 * t * t * inner)
    vectors = (3 * inner + d + f + d) * 4 * 2
    return ops, block_macs(c) + vectors + rows * t * d * 2 * 2


def step_rest(c: dict, rows: int, t: int) -> int:
    """Operations of one Euler step outside the blocks (bf16): the input
    projection (x, cond and text), the two grouped k=31 position convolutions
    (16 groups), and the output projection."""
    d = c["cfm_dit_dim"]
    mel, text = c["cfm_mel_channels"], 512
    macs = (2 * mel + text) * d + 2 * d * (d // 16) * 31 + d * mel
    return 2 * rows * t * macs


def call(c: dict, rows: int, t: int, steps: int) -> dict:
    """Operations of one CFM call by precision: {"int8": blocks, "bf16": the
    rest of each step}."""
    ops, _ = block(c, rows, t)
    return {"int8": steps * c["cfm_dit_depth"] * ops, "bf16": steps * step_rest(c, rows, t)}
