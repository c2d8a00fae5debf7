"""What the benchmark's span around each K1 call (the rows' write slots)
says about the S1 pool's rows, and the counts of the work they did."""

from __future__ import annotations

from bench_port.flops import s1 as s1_flops


def live_rows(calls: list, t_a: float, t_b: float) -> list:
    """For each K1 call made in [t_a, t_b] after the first one recorded, the
    write slots of the rows that decoded at it: those whose slot moved on by
    one from the call before. (A row's first step after it joins writes at
    the same slot as an empty row and is not counted.)"""
    out = []
    for (_, prev), (t, cur) in zip(calls, calls[1:]):
        if t_a <= t <= t_b:
            out.append([s for p, s in zip(prev, cur) if s == p + 1])
    return out


def prefix_floor(cfg: dict, sentences: dict) -> int:
    """The fewest tokens a row holds before its first generated token: the
    shortest sentence's phones and the prompt's semantic tokens."""
    ra = cfg["reference_audio"]
    samples = int(ra["seconds"] * 16000) + int(16000 * 0.3)
    return min(len(s["phones"]) for s in sentences["sentences"]) + s1_flops.prompt_tokens(cfg["hubert"], samples)


def k1_least_s(run, t_a: float, t_b: float) -> float:
    """The least time the K1 steps called in [t_a, t_b] need: each step's
    int8 weights once and each decoding row's K/V at (at least) its length,
    or its operations at the int8 peak, whichever is longer."""
    from bench_port.flops.peaks import bound_s

    c = run.cfg["s1"]
    scratch = run.cfg["serving"]["tx_max"] + run.cfg["serving"]["tp_max"]
    floor = prefix_floor(run.cfg, run.sentences)
    total = 0.0
    for slots in live_rows(run.k1_calls, t_a, t_b):
        if slots:
            ops, nbytes = s1_flops.decode_step(c, [floor + s - scratch for s in slots])
            total += bound_s(ops, nbytes, run.cfg["precision"]["s1_weights"])
    return total
