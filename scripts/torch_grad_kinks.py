"""Where the card's float32 gradients of chip_smoke.train_s2_phase's check
step leave the CPU's: D's first AdamW step (lr * g / (|g| + eps) flips with
the sign of a gradient element near 0) or the kinks of G's own graph.

    python3 scripts/torch_grad_kinks.py [TRIALS]    # one CUDA card, from the repository root

Each trial trains the full-width v2ProPlus S2 for one epoch on
chip_smoke.write_corpus's synthetic experiment (run_train_s2), then runs the
check step at B=1 from the trained weights on the card, on the CPU and on
the CPU in float64, and once more on the card and the CPU with D's update
replaced by the float64 run's (Follow). One JSON line a trial: the elements
whose |x| or leaky ReLU input lies on the other side of its kink than in
the float64 run, D's update elements that differ by more than half a step,
and the tensors that miss check_grads' 1e-3 bar with each tensor's error
against float64.
"""
import copy, json, sys, tempfile
from pathlib import Path
import torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke as c
from gpt_sovits_tpu_torch.run import run_train_s2
from gpt_sovits_tpu_torch.train import s2_train
from gpt_sovits_tpu_torch.train.data import BucketSampler, S2Dataset, batch_to
from gpt_sovits_tpu_torch.utils.config import MelConfig, TrainConfig, s2_config_for_version


class Follow:
    """D's optimizer: its own AdamW step, then D's weights set to `target`."""
    def __init__(self, opt, target):
        self.opt, self.target, self.params = opt, target, opt.params
    def zero_grad(self):
        self.opt.zero_grad()
    def step(self):
        self.opt.step()
        with torch.no_grad():
            for p, t in zip(self.params, self.target):
                p.copy_(t.to(p.device, p.dtype))
        return True


SIGNS = []
_abs, _lrelu = torch.abs, F.leaky_relu
def rec_abs(x, *a, **k):
    if x.grad_fn is not None:
        SIGNS.append(("abs", (x.detach() > 0).cpu()))
    return _abs(x, *a, **k)
def rec_lrelu(x, *a, **k):
    if x.grad_fn is not None:
        SIGNS.append(("lrelu", (x.detach() > 0).cpu()))
    return _lrelu(x, *a, **k)


c.resolve_device("cuda")
print(c.card_line(), flush=True)
trials = int(sys.argv[1]) if len(sys.argv) > 1 else 6
with tempfile.TemporaryDirectory() as tmp:
    exp = Path(tmp) / "exp"
    c.write_corpus(exp, seed=0)
    cfg = s2_config_for_version("v2ProPlus")
    for trial in range(trials):
        r = run_train_s2(str(exp), f"{tmp}/s2_{trial}", version="v2ProPlus", batch_size=4, epochs=1, save_every=1,
                         model_cfg=cfg, seed=0, log=lambda *a, **k: None)
        gen, disc = r["models"]["g"], r["models"]["d"]
        mel = MelConfig(); tc = TrainConfig(batch_size=4)
        ds = S2Dataset(str(exp), version="v2ProPlus", mel_cfg=mel)
        sampler = BucketSampler(ds.lengths(), 4, seed=0)
        small = min(sampler.epoch_batches(0), key=lambda idx: max(ds.lengths()[i] for i in idx))
        one = batch_to(ds.collate([small[0]]), "cpu")
        t = one["spec"].shape[1]
        noise = torch.randn((1, t, cfg.inter_channels), generator=torch.Generator().manual_seed(0))
        starts = torch.tensor([max(int(one["spec_lengths"][0]) - cfg.segment_size, 0) // 2])
        grads, dgrads, d_after, signs = {}, {}, {}, {}
        for tag in ("f64", "cpu", "card", "card_fix", "cpu_fix"):
            dev = "cuda" if tag.startswith("card") else "cpu"
            g, d = copy.deepcopy(gen).to(dev), copy.deepcopy(disc).to(dev)
            b = batch_to(one, dev)
            if tag == "f64":
                g, d, b = g.double(), d.double(), c.as_float64(b)
            opt_d = s2_train.make_optimizer_d(d, tc, 4)
            if tag.endswith("_fix"):
                opt_d = Follow(opt_d, d_after["f64"])
            fn = s2_train.make_train_step(g, d, s2_train.make_optimizer_g(g, tc, 4), opt_d, tc, mel)
            SIGNS.clear()
            torch.abs, F.leaky_relu = rec_abs, rec_lrelu
            try:
                fn(b, noise=noise, ids_slice=starts)
            finally:
                torch.abs, F.leaky_relu = _abs, _lrelu
            signs[tag] = list(SIGNS)
            grads[tag] = c.grads_of(g)
            dgrads[tag] = c.grads_of(d)
            d_after[tag] = [p.detach().clone() for p in d.parameters()]
        keys = [k for k in grads["f64"] if float(grads["f64"][k].norm()) >= 1e-6 * float(grads["cpu"][k].norm())]
        err = {tag: {k: c.rel_l2(grads[tag][k], grads["f64"][k]) for k in keys} for tag in grads if tag != "f64"}
        miss = {k for k in keys if c.rel_l2(grads["card"][k], grads["cpu"][k]) >= 1e-3
                or c.rel_l2(grads["card_fix"][k], grads["cpu_fix"][k]) >= 1e-3}
        # D's update: elements whose step differs from the float64 run's by more than half the step
        lr_now = [abs(float((a.double().cpu() - b0.double().cpu()).abs().max())) for a, b0 in
                  zip(d_after["f64"], disc.parameters())]
        step_size = max(lr_now)
        dflip = {tag: int(sum(int(((a.double().cpu() - b0.double().cpu()).abs() > step_size / 2).sum())
                              for a, b0 in zip(d_after[tag], d_after["f64"]))) for tag in ("cpu", "card")}
        def flips(tag):
            out = {}
            for (kind, s), (_, s64) in zip(signs[tag], signs["f64"]):
                out[kind] = out.get(kind, 0) + int((s != s64).sum())
            return out
        rule_p = {k: err["card"][k] <= min(10 * err["cpu"][k], 0.1) for k in miss}
        rule_fix = {k: c.rel_l2(grads["card_fix"][k], grads["cpu_fix"][k]) < 1e-3
                    or err["card_fix"][k] <= min(10 * err["cpu_fix"][k], 0.1) for k in miss}
        top = {tag: sorted(err[tag].items(), key=lambda kv: -kv[1])[:3] for tag in err}
        print(json.dumps({"trial": trial, "d_step": step_size, "d_flips": dflip,
                          "kink_flips": {t: flips(t) for t in ("cpu", "card", "card_fix", "cpu_fix")},
                          "n_sign_records": len(signs["f64"]), "miss": sorted(miss),
                          "rule_p_ok": all(rule_p.values()), "rule_fix_ok": all(rule_fix.values()),
                          "detail": {k: {t: err[t][k] for t in err} for k in miss},
                          "card_fix_vs_cpu_fix_max": max(c.rel_l2(grads["card_fix"][k], grads["cpu_fix"][k]) for k in keys),
                          "card_vs_cpu_max": max(c.rel_l2(grads["card"][k], grads["cpu"][k]) for k in keys),
                          "d_grad_card_vs_cpu_max": max(c.rel_l2(dgrads["card"][k], dgrads["cpu"][k]) for k in dgrads["cpu"]),
                          "top": top}), flush=True)
        torch.cuda.empty_cache()
