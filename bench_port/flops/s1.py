"""Operations and bytes of S1 (the text -> semantic transformer); `c` is a
configuration file's "s1" object. An operation is a multiply or an add: a
multiply-accumulate counts 2."""

from __future__ import annotations


def layer_macs(c: dict) -> int:
    """Weight multiply-accumulates of one layer for one token: q||k||v, out,
    and the two FFN matrices."""
    d, f = c["hidden_dim"], c["ffn_dim"]
    return 3 * d * d + d * d + 2 * d * f


def decode_step(c: dict, kv_lens) -> tuple[int, int]:
    """(operations, bytes) of one cached decode step through every layer
    for rows that attend over `kv_lens` cached tokens each, with int8 weights
    (one f32 scale an output channel, f32 vectors) and an int8 K||V cache
    (one f32 scale a token for K and for V): every weight read once, each
    row's cached K/V read once, its new K/V and scales written once, its
    input and output read and written once (f32)."""
    n_l, d, f = c["num_layers"], c["hidden_dim"], c["ffn_dim"]
    rows = len(kv_lens)
    ops = sum(2 * n_l * layer_macs(c) + 4 * n_l * d * (n + 1) for n in kv_lens)
    weights = n_l * layer_macs(c) + n_l * (3 * d + d + f + d) * 4 + n_l * (3 * d + d + 4 * d + f + d) * 4
    kv = sum(n_l * n * (2 * d + 8) for n in kv_lens) + rows * n_l * (2 * d + 8)
    return ops, weights + kv + rows * d * 4 * 2


def prefill(c: dict, tx: int, tp: int) -> int:
    """Operations of the full-sequence forward over tx text and tp prompt
    tokens: the layers' matrices, and attention over the keys each row may
    see (text rows all text; audio rows the text and the audio up to
    themselves)."""
    n_l, d = c["num_layers"], c["hidden_dim"]
    pairs = tx * tx + tp * tx + tp * (tp + 1) // 2
    return 2 * n_l * layer_macs(c) * (tx + tp) + 4 * n_l * d * pairs


def head(c: dict) -> int:
    """Operations of the output head for one token."""
    return 2 * c["hidden_dim"] * c["vocab_size"]


def decode_ops(c: dict, n_tokens: int, prefix: int) -> int:
    """Operations of decoding n tokens after a prefix of `prefix` tokens,
    one at a time through the cache: the layers (the step at position j
    attends over prefix + j cached tokens and itself)."""
    n_l, d = c["num_layers"], c["hidden_dim"]
    attended = n_tokens * (prefix + 1) + n_tokens * (n_tokens - 1) // 2
    return 2 * n_l * layer_macs(c) * n_tokens + 4 * n_l * d * attended


def prompt_tokens(h: dict, samples_16k: int) -> int:
    """Semantic tokens of a prompt of that many 16 kHz samples: CNHuBERT's
    convolution stack (50 Hz), then the 2-stride projection (25 Hz)."""
    n = samples_16k
    for k, s in zip(h["conv_kernels"], h["conv_strides"]):
        n = (n - k) // s + 1
    return (n - 2) // 2 + 1
