"""chip_smoke.py's training phases on one CUDA card: train_s2 N times (its
card-vs-CPU gradient check from freshly trained weights each time), then
train_s1, train_v3 (v4), train_v3_lora (v3, rank 32) and train_bigvgan once,
each with K1-K7 counted from 0. One JSON line a phase: the replayed
branches that flipped, check_grads' summary and the losses.

    python3 scripts/torch_train_repeat.py [N]    # from the repository root
"""
import json, sys, tempfile, time, traceback
from pathlib import Path
sys.path.insert(0, ".")
import torch
import chip_smoke as c

c.resolve_device("cuda")
print(c.card_line(), flush=True)
n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
ok = True


def short(rec):
    cvc = rec["card_vs_cpu"]
    out = {"branch_flips": cvc.get("branch_flips")}
    for k in ("g", "d", "grads"):
        if k in cvc:
            out[k] = {kk: cvc[k][kk] for kk in ("params", "within_bar", "max_within_bar", "held_by_f64")}
    out["losses"] = cvc.get("losses", cvc.get("loss"))
    return out


with tempfile.TemporaryDirectory() as tmp:
    exp = Path(tmp) / "exp"
    c.write_corpus(exp, seed=0)
    phases = [(f"train_s2#{i}", c.train_s2_phase) for i in range(n)] + [
        ("train_s1", c.train_s1_phase),
        ("train_v3", lambda e, d, s: c.train_v3_phase(e, d, s, version="v4")),
        ("train_v3_lora", lambda e, d, s: c.train_v3_phase(e, d, s, version="v3", lora_rank=32)),
        ("train_bigvgan", lambda e, d, s: c.train_bigvgan_phase(e, s))]
    for i, (name, fn) in enumerate(phases):
        c.reset_all_launch_counts()
        t0 = time.perf_counter()
        try:
            rec = fn(str(exp), f"{tmp}/p{i}", 0)
            print(json.dumps({"phase": name, "phase_s": time.perf_counter() - t0, **short(rec),
                              "launches": c.launches_zero(name)}, default=str), flush=True)
        except Exception:
            ok = False
            print(json.dumps({"phase": name, "FAILED": traceback.format_exc()[-1500:]}), flush=True)
        torch.cuda.empty_cache()
raise SystemExit(0 if ok else 1)
