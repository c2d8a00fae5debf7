"""Worker of tests/test_torch_parallel.py: one process of a data-parallel
group on the CPU (gloo), or the one-process reference.

    python torch_dp_worker.py <out.pt> <port> <world> <rank> <corpus dir>

`steps` runs one S2 G+D step, one S1 update (DPO on, two micro-steps of
accumulation) and one v3 CFM step at tiny widths from seeded weights, and
three VQ EMA updates, each rank on its rows of one global batch with the
global batch's draws;
`entry_point` runs run_train_v3(data_parallel=True) on the corpus and records
which rank wrote which file. The result is torch.save'd to <out.pt>.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gpt_sovits_tpu_torch.models.discriminators import MultiPeriodDiscriminator, periods_for
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.train import s1_train, s2_train, s2_train_v3
from gpt_sovits_tpu_torch.utils import config

GB = 4  # the global batch
S2 = dict(version="v2ProPlus", spec_channels=65, segment_size=8, inter_channels=16, hidden_channels=16,
          filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, upsample_rates=(8, 8),
          upsample_initial_channel=32, upsample_kernel_sizes=(16, 16), resblock_kernel_sizes=(3,),
          resblock_dilation_sizes=((1, 3),), gin_channels=16, mrte_hidden=16, ssl_dim=16, n_codes=17, sv_dim=24)
MEL = dict(sampling_rate=8000, n_fft=128, win_size=128, hop_size=64, num_mels=13)
S1 = dict(vocab_size=41, phoneme_vocab_size=37, embedding_dim=32, hidden_dim=32, num_heads=4, ffn_dim=64,
          num_layers=2, eos_id=40, bert_dim=16, max_len=64)
V3 = dict(version="v3", spec_channels=65, inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
          n_layers=2, kernel_size=3, gin_channels=16, mrte_hidden=16, ssl_dim=16, n_codes=17, cfm_mel_channels=12,
          cfm_dit_depth=2, cfm_dit_dim=32, cfm_dit_heads=2)
V3_TINY = dict(V3, spec_channels=1025, cfm_mel_channels=100, n_codes=12)  # for the corpus (MelConfig, MEL_V3)


def _rows(x, world: int, rank: int):
    n = x.shape[0] // world
    return x[rank * n : (rank + 1) * n]


def _shard(batch: dict, world: int, rank: int) -> dict:
    return {k: _rows(v, world, rank) for k, v in batch.items()}


def _params(models) -> dict:
    return {f"{i}.{n}": p.detach().clone() for i, m in enumerate(models) for n, p in m.named_parameters()}


def _result(models, metrics, before: dict) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {f"{i}.{n}": p.grad.clone() for i, m in enumerate(models) for n, p in m.named_parameters()
                      if p.grad is not None},
            "change": {k: v - before[k] for k, v in _params(models).items()}}


def s2_step(world: int, rank: int) -> dict:
    rng = np.random.default_rng(0)
    t = 20
    batch = {
        "ssl": rng.standard_normal((GB, 2 * t, S2["ssl_dim"])).astype(np.float32),
        "spec": (rng.standard_normal((GB, t, S2["spec_channels"])) * 0.3 + 1.0).astype(np.float32),
        "spec_lengths": np.asarray([t, t - 3, t - 1, t - 5]),
        "wav": (rng.standard_normal((GB, t * MEL["hop_size"], 1)) * 0.1).astype(np.float32),
        "text": rng.integers(0, 700, (GB, 6)),
        "text_lengths": np.asarray([6, 4, 5, 3]),
        "sv_emb": rng.standard_normal((GB, S2["sv_dim"])).astype(np.float32),
    }
    noise = rng.standard_normal((GB, t, S2["inter_channels"])).astype(np.float32)
    starts = np.asarray([3, 0, 7, 2])
    cfg = config.S2Config(**S2)
    torch.manual_seed(0)
    # two periods: the discriminators' widths are fixed, so their number sets the step's cost
    gen, disc = SynthesizerTrn(cfg, posterior=True), MultiPeriodDiscriminator(periods_for(cfg)[:2])
    tc = config.TrainConfig(batch_size=GB)
    step = s2_train.make_train_step(gen, disc, s2_train.make_optimizer_g(gen, tc, 4),
                                    s2_train.make_optimizer_d(disc, tc, 4), tc, config.MelConfig(**MEL))
    local = {k: torch.from_numpy(np.asarray(v)) for k, v in _shard(batch, world, rank).items()}
    before = _params((gen, disc))
    m = step(local, noise=_rows(noise, world, rank), ids_slice=_rows(starts, world, rank))
    return _result((gen, disc), m, before)


def s1_step(world: int, rank: int) -> dict:
    rng = np.random.default_rng(1)
    tx, ty = 12, 20
    micro = []
    for _ in range(2):
        micro.append({
            "phoneme_ids": rng.integers(0, S1["phoneme_vocab_size"], (GB, tx)),
            "phoneme_lens": rng.integers(5, tx + 1, GB),
            "semantic_ids": rng.integers(0, S1["eos_id"], (GB, ty)),
            "semantic_lens": rng.integers(8, ty + 1, GB),
            "bert_features": rng.standard_normal((GB, tx, S1["bert_dim"])).astype(np.float32),
        })
    rejects = [(rng.integers(0, 7, GB), rng.random(GB) < 0.5) for _ in range(2)]
    torch.manual_seed(1)
    model = T2SDecoder(config.S1Config(**S1))
    opt = s1_train.make_optimizer(model.parameters(), config.TrainConfig(grad_accum=2, warmup_steps=10))
    step = s1_train.make_train_step(model, opt, use_dpo=True)
    before = _params((model,))
    for b, (pos, mode) in zip(micro, rejects):
        local = {k: torch.from_numpy(np.asarray(v)) for k, v in _shard(b, world, rank).items()}
        m = step(local, reject=(_rows(pos, world, rank), _rows(mode, world, rank)))
    assert opt.updates == 1
    return _result((model,), {"loss": m["loss"], "tokens": m["tokens"]}, before)


def v3_step(world: int, rank: int) -> dict:
    rng = np.random.default_rng(2)
    ts, tm = 24, 45
    batch = {
        "ssl": rng.standard_normal((GB, ts, V3["ssl_dim"])).astype(np.float32),
        "spec": (np.abs(rng.standard_normal((GB, ts, V3["spec_channels"]))) * 0.3).astype(np.float32),
        "spec_lengths": np.asarray([ts, ts - 4, ts - 2, ts]),
        "mel": (rng.standard_normal((GB, tm, V3["cfm_mel_channels"])) * 0.3).astype(np.float32),
        "mel_lengths": np.asarray([tm, tm - 6, tm - 1, tm - 9]),
        "text": rng.integers(0, 700, (GB, 6)),
        "text_lengths": np.asarray([6, 4, 5, 6]),
    }
    torch.manual_seed(2)
    model = SynthesizerTrnV3(config.S2Config(**V3))
    t = min(tm, int(ts * model.interp_factor))
    g = torch.Generator().manual_seed(5)
    draws = {"prompt_u": torch.rand(GB, generator=g), "tt": torch.rand(GB, generator=g),
             "x0": torch.randn((GB, t, V3["cfm_mel_channels"]), generator=g), "use_boot": torch.tensor(True),
             "base": torch.randint(2, 8, (GB,), generator=g)}
    local_draws = {k: v if k == "use_boot" else _rows(v, world, rank) for k, v in draws.items()}
    step = s2_train_v3.make_train_step(model, s2_train_v3.make_optimizer(model, config.TrainConfig(batch_size=GB), 4))
    local = {k: torch.from_numpy(np.asarray(v)) for k, v in _shard(batch, world, rank).items()}
    before = _params((model,))
    return _result((model,), step(local, draws=local_draws), before)


def vq_ema(world: int, rank: int) -> dict:
    """Three EMA-kmeans codebook updates, each rank on its rows."""
    rng = np.random.default_rng(3)
    embed = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    state = s2_train.VQEmaState.init(embed)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((GB * 8, 4)).astype(np.float32))
        codes = torch.from_numpy(rng.integers(0, 8, GB * 8))
        embed, state = s2_train.vq_ema_update(embed, state, _rows(x, world, rank), _rows(codes, world, rank),
                                              decay=0.9)
    return {"embed": embed, "cluster_size": state.cluster_size, "embed_avg": state.embed_avg}


def entry_point(corpus: str, ckpt_dir: str, world: int, rank: int) -> dict:
    """run_train_v3(data_parallel=True): what each rank wrote, and its weights."""
    from gpt_sovits_tpu_torch import run
    from gpt_sovits_tpu_torch.train import ckpt as ckpt_io

    written = []
    for name in ("save_checkpoint", "export_weights", "save_reference_pth"):
        fn = getattr(ckpt_io, name)
        setattr(ckpt_io, name, lambda *a, _fn=fn, _n=name, **k: written.append(_n) or _fn(*a, **k))
    r = run.run_train_v3(corpus, ckpt_dir, batch_size=4, epochs=1, save_every=1, model_cfg=config.S2Config(**V3_TINY),
                         data_parallel=True, device="cpu", log=lambda *a, **k: None)
    return {"written": written, "exports": r["exports"], "step": r["step"], "metrics": r["metrics"],
            "params": {n: p.detach().clone() for n, p in r["models"]["s2"].named_parameters()}}


def main(out: str, port: int, world: int, rank: int, corpus: str) -> None:
    from gpt_sovits_tpu_torch.parallel import launch

    sys.modules["torch.utils.tensorboard"] = None  # MetricsLogger writes JSONL only (no TensorFlow import)
    torch.set_num_threads(1)
    launch.init(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        res = {"s2": s2_step(world, rank), "s1": s1_step(world, rank), "v3": v3_step(world, rank),
               "vq": vq_ema(world, rank),
               "entry": entry_point(corpus, f"{corpus}_ckpt", world, rank), "host": launch.host_info(),
               "shard": launch.host_shard(list(range(10)))}
    finally:
        launch.shutdown()
    torch.save(res, out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
