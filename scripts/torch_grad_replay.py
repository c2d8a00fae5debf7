"""chip_smoke.train_s2_phase's check step with the reference runs on the
card's branches: every |x|, leaky ReLU, ReLU and clamp(min) inside the
step's graph takes the side the card's float32 run took (Branches), and D's
first AdamW step is the card's (Follow). Does the card's G gradient then
meet check_grads' rule in every trial?

    python3 scripts/torch_grad_replay.py [TRIALS]    # one CUDA card, from the repository root

Each trial trains the full-width v2ProPlus S2 for one epoch
(run_train_s2), then runs the check step at B=1 on the card, on the CPU and
on the CPU in float64 with their own branches, and on the CPU in float32
and float64 on the card's. One JSON line a trial: the replayed decisions
that differ from each run's own, the tensors that miss the rule on the
plain and on the replayed comparison, and the largest errors.
"""
import copy, json, sys, tempfile
from collections import Counter
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


_abs, _lrelu, _relu, _clamp = torch.abs, F.leaky_relu, torch.relu, torch.clamp


class Branches:
    def __init__(self, rec=None):
        self.rec, self.replay, self.i = ([] if rec is None else rec), rec is not None, 0
        self.flips, self.total = Counter(), Counter()
    def decide(self, kind, x, fn):
        if not (torch.is_grad_enabled() and x.requires_grad and x.is_floating_point() and not x.is_complex()):
            return None
        own = fn(x.detach())
        if not self.replay:
            self.rec.append((kind, own.cpu()))
            return None
        k0, m = self.rec[self.i]; self.i += 1
        assert k0 == kind and m.shape == own.shape, (k0, kind)
        m = m.to(x.device)
        self.flips[kind] += int((m != own).sum()); self.total[kind] += m.numel()
        return m
    def __enter__(self):
        b = self
        def abs_(x, *a, **k):
            s = b.decide("abs", x, torch.sign)
            return _abs(x, *a, **k) if s is None else x * s.to(x.dtype)
        def lrelu(x, negative_slope=0.01, inplace=False):
            m = b.decide("lrelu", x, lambda v: v > 0)
            return _lrelu(x, negative_slope, inplace) if m is None else torch.where(m, x, x * negative_slope)
        def relu(x):
            m = b.decide("relu", x, lambda v: v > 0)
            return _relu(x) if m is None else x * m.to(x.dtype)
        def clamp(x, min=None, max=None, **k):
            if min is None or max is not None or not isinstance(min, (int, float)):
                return _clamp(x, min, max, **k)
            m = b.decide("clamp", x, lambda v: v >= min)
            return _clamp(x, min=min, **k) if m is None else torch.where(m, x, torch.full_like(x, min))
        torch.abs, F.leaky_relu, torch.relu, torch.clamp = abs_, lrelu, relu, clamp
        return self
    def __exit__(self, *a):
        torch.abs, F.leaky_relu, torch.relu, torch.clamp = _abs, _lrelu, _relu, _clamp


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
        grads, dgrads, flips, losses = {}, {}, {}, {}
        rec, d_card = None, None
        for tag in ("card", "f64", "cpu", "f64_rep", "cpu_rep"):
            dev = "cuda" if tag == "card" else "cpu"
            g, d = copy.deepcopy(gen).to(dev), copy.deepcopy(disc).to(dev)
            b = batch_to(one, dev)
            if tag.startswith("f64"):
                g, d, b = g.double(), d.double(), c.as_float64(b)
            opt_d = s2_train.make_optimizer_d(d, tc, 4)
            if tag.endswith("_rep"):
                opt_d = Follow(opt_d, d_card)
            fn = s2_train.make_train_step(g, d, s2_train.make_optimizer_g(g, tc, 4), opt_d, tc, mel)
            br = Branches(rec if tag.endswith("_rep") else None)
            with br:
                m = fn(b, noise=noise, ids_slice=starts)
            losses[tag] = {k: float(v) for k, v in m.items()}
            if tag == "card":
                rec, d_card = br.rec, [p.detach().clone() for p in d.parameters()]
            if tag.endswith("_rep"):
                assert br.i == len(rec), (br.i, len(rec))
                flips[tag] = {k: [br.flips[k], br.total[k]] for k in br.total}
            grads[tag] = c.grads_of(g)
            dgrads[tag] = c.grads_of(d)
        keys = [k for k in grads["f64"] if float(grads["f64"][k].norm()) >= 1e-6 * float(grads["cpu"][k].norm())]
        def errs(a, b0): return {k: c.rel_l2(grads[a][k], grads[b0][k]) for k in keys}
        e_card_rep, e_cpu_rep = errs("card", "f64_rep"), errs("cpu_rep", "f64_rep")
        e_card, e_cpu = errs("card", "f64"), errs("cpu", "f64")
        vs_cpu, vs_cpu_rep = errs("card", "cpu"), errs("card", "cpu_rep")
        miss_p = {k for k in keys if vs_cpu[k] >= 1e-3 and not e_card[k] <= min(10 * e_cpu[k], 0.1)}
        miss_rep = {k for k in keys if vs_cpu_rep[k] >= 1e-3 and not e_card_rep[k] <= min(10 * e_cpu_rep[k], 0.1)}
        top = lambda e: sorted(e.items(), key=lambda kv: -kv[1])[:3]
        print(json.dumps({"trial": trial, "n_branch_records": len(rec), "flips_vs_card": flips,
                          "miss_rule_p": sorted(miss_p), "miss_rule_p_rep": sorted(miss_rep),
                          "max_card_vs_cpu": max(vs_cpu.values()), "max_card_vs_cpu_rep": max(vs_cpu_rep.values()),
                          "top_card_vs_f64_rep": top(e_card_rep), "top_cpu_rep_vs_f64_rep": top(e_cpu_rep),
                          "top_card_vs_f64": top(e_card),
                          "d_card_vs_cpu": max(c.rel_l2(dgrads["card"][k], dgrads["cpu"][k]) for k in dgrads["cpu"]),
                          "d_card_vs_cpu_rep": max(c.rel_l2(dgrads["card"][k], dgrads["cpu_rep"][k]) for k in dgrads["cpu"]),
                          "loss_g": {t: losses[t]["loss_g"] for t in losses}}), flush=True)
        torch.cuda.empty_cache()
