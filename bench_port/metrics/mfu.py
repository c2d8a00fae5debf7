"""mfu: the window's completed work at the card's published dense peaks, as
a share of the window, in %. For each request completed in the window, each
component's operations (bench_port/flops/) at the peak of the precision the
configuration states for it: S1's prefill, cached decode and head; then S2
(decode_latent) and the HiFiGAN generator (v2 family), or v4's conditioning,
the CFM calls and the vocoder. The sum of those seconds over the window's
seconds. It bounds the whole step: a kernel taken off the path leaves its
roofline silent, not this."""


def _s1_s(run, n: int, m: int, prompt: int) -> float:
    from bench_port.flops import s1
    from bench_port.flops.peaks import compute_s

    c, p = run.cfg["s1"], run.cfg["precision"]
    return (compute_s(s1.prefill(c, m, prompt), p["s1_prefill"])
            + compute_s(s1.decode_ops(c, n, m + prompt), p["s1_weights"])
            + compute_s(n * s1.head(c), p["s1_head"]))


def read(run):
    from bench_port.flops import dit, s1, vits
    from bench_port.flops.peaks import compute_s

    if not run.done or run.window_s <= 0:
        return None
    cfg, p = run.cfg, run.cfg["precision"]
    ra = cfg["reference_audio"]
    prompt = s1.prompt_tokens(cfg["hubert"], int(ra["seconds"] * 16000) + int(16000 * 0.3))
    phones = {i: len(s["phones"]) for i, s in enumerate(run.sentences["sentences"])}
    total = 0.0
    for r in run.done:
        ms = [phones[i] for i in r["req"]["sentences"]]
        if cfg["family"] == "vits":
            c = cfg["s2"]
            for toks, m in zip(r["tokens"], ms):
                n = len(toks)
                total += _s1_s(run, n, m, prompt)
                total += compute_s(vits.s2_decode(c, n, m), p["s2"])
                total += compute_s(vits.generator(c, 2 * n, c["inter_channels"]), p["vocoder"])
            continue
        c, cfm, voc = cfg["s2"], cfg["cfm"], cfg["vocoder"]
        for g in r["groups"]:
            for toks, ph in zip(g["tokens"], g["phones"]):
                n, m = len(toks), len(ph)
                total += _s1_s(run, n, m, prompt) + compute_s(vits.encp(c, n, m), p["encp"])
        for bs, _ in r["cfm_batch"]:
            ops = dit.call(c, bs, cfm["t_chunk"], cfm["sample_steps"])
            total += compute_s(ops["int8"], p["dit_blocks"]) + compute_s(ops["bf16"], p["dit"])
            frames = bs * (cfm["t_chunk"] - cfm["t_ref"])
            total += compute_s(vits.generator(voc, frames, voc["in_channels"]), p["vocoder"])
    return 100.0 * total / run.window_s
