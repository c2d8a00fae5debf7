"""Library entry points for data preparation and training (port of
gpt_sovits_tpu/run.py `run_prepare`, `run_train_s1` / `run_train_s2` /
`run_train_v3` and `latest_step_model`): a `.list` manifest to a prepared
experiment directory (prepare/extract.py, on the models of
utils/loaders.py); the v2 fine-tune recipe, S2 first, then S1, and the
v3/v4 CFM fine-tune (full or LoRA), from a prepared experiment directory
(train/data.py) to full checkpoints and reference-format weights in
`ckpt_dir`.

All run on the CUDA device unless `device` says otherwise (`device="cpu"`),
in float32 with TF32 off (`resolve_device`). A run resumes from the newest
full checkpoint in `ckpt_dir` at the epoch after it; without one it starts
from `pretrained*` reference checkpoints when given, else from weights
made from `seed`. Each epoch's randomness (DPO rejects, posterior noise,
segment starts, CFM draws) comes from a CPU generator seeded from (seed,
epoch), so a resumed run equals an uninterrupted one and a card run draws
what a CPU run draws. Every `save_every` epochs: a full checkpoint
`state_{step}`, and fp16 exports `s1-e{n}.ckpt`/`.npz`, `s2G-e{n}.pth`/
`.npz` or `s2G-{version}-e{n}.pth`/`.npz`.

`data_parallel=True` trains on every process of the group that
`parallel/launch.init` joined, as the JAX package's rules have it
(gpt_sovits_tpu/run.py:33-80): a world of one runs exactly as without it;
`batch_size` must divide by the world; each rank draws its batch_size /
world items through BucketSampler(num_shards=world, shard_id=rank) and its
randomness from (seed, epoch, rank); the step is the global batch's
(parallel/sync.py); rank 0 alone writes checkpoints, exports and metrics.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import numpy as np
import torch


def epoch_generator(seed: int, epoch: int, rank: int = 0) -> torch.Generator:
    """The CPU generator of one epoch's draws on one rank (rank 0's is the
    single-process run's)."""
    key = [seed, epoch] if rank == 0 else [seed, epoch, rank]
    return torch.Generator().manual_seed(int(np.random.SeedSequence(key).generate_state(1)[0]))


def _dp_world(data_parallel: bool, batch_size: int) -> tuple[int, int]:
    """(world, rank) of a data-parallel run; (1, 0) without one or in a
    group of one. The steps sum their gradients over any process group
    (parallel/sync.py), so a group of more than one needs
    data_parallel=True: the flag and the group decide together."""
    from gpt_sovits_tpu_torch.parallel import launch, sync

    n = sync.world()
    if n > 1 and not data_parallel:
        raise ValueError(f"a process group of {n} is initialised: pass data_parallel=True")
    if n == 1:
        return 1, 0
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by {n} processes")
    return n, launch.process_index()


def _sampler(lengths, batch_size: int, seed: int, world: int, rank: int):
    from gpt_sovits_tpu_torch.train.data import BucketSampler

    sampler = BucketSampler(lengths, batch_size // world, seed=seed, num_shards=world, shard_id=rank)
    n_batches = len(sampler.epoch_batches(0))
    if not n_batches:
        raise RuntimeError("no training batches (dataset too small for batch size)")
    return sampler, n_batches


def _check_f32(*models) -> None:
    """Training runs in float32: the pipeline's bf16/int8 serving weights must
    not reach a trainer."""
    for m in models:
        bad = sorted({str(p.dtype) for p in m.parameters() if p.dtype != torch.float32})
        if bad:
            raise TypeError(f"{type(m).__name__} holds {bad} parameters; training runs in float32")


def run_prepare(list_file: str, exp_dir: str, *, version: str = "v2", bert: Optional[str] = None,
                hubert: Optional[str] = None, s2: Optional[str] = None, sv: Optional[str] = None, device=None,
                log: Callable[..., None] = print) -> None:
    """Dataset feature extraction (reference prepare_datasets/1-get-text.py,
    2-get-hubert-wav32k.py, 2-get-sv.py, 3-get-semantic.py in one call), on
    the reference's model files: chinese-roberta's layer -3 for the zh
    lines (`bert`, f32), CNHuBERT features and the 32 kHz wavs (`hubert`),
    the semantic codes of the S2 file's quantizer (`s2`) and ERes2NetV2
    embeddings over `kaldi_fbank` (`sv`). A stage whose model is not given
    is skipped, as in the JAX package; the models run on `device` (None:
    CUDA)."""
    from gpt_sovits_tpu_torch import resolve_device
    from gpt_sovits_tpu_torch.prepare import extract
    from gpt_sovits_tpu_torch.utils.loaders import load_bert, load_hubert, load_s2, load_sv

    dev = resolve_device(device)
    os.makedirs(exp_dir, exist_ok=True)
    for problem in extract.check_details(list_file=list_file):  # my_utils.check_details
        log(f"warning: {problem}", file=sys.stderr)

    bert_fn = None
    if bert:
        bert_model, tok = load_bert(bert)
        bert_model.to(dev, torch.float32).eval()

        @torch.no_grad()
        def bert_fn(norm_text, word2ph):
            ids = torch.from_numpy(tok(norm_text, return_tensors="np")["input_ids"]).to(dev)
            hidden = bert_model(ids)[-3][0, 1:-1].float().cpu().numpy()
            return np.repeat(hidden, word2ph, axis=0)

    extract.prepare_text(list_file, exp_dir, version=version, bert_fn=bert_fn)
    extract.merge_text_shards(exp_dir, 1)

    if hubert:
        hubert_model = load_hubert(hubert).to(dev).eval()

        @torch.no_grad()
        def hubert_fn(w):
            return hubert_model(torch.from_numpy(np.asarray(w, np.float32)[None]).to(dev))[0].float().cpu().numpy()

        extract.prepare_audio(list_file, exp_dir, hubert_fn=hubert_fn)

    if s2:
        model, _ = load_s2(s2, version if version in ("v1", "v2") else None)
        model.to(dev).eval()

        @torch.no_grad()
        def extract_latent_fn(ssl):
            return model.extract_latent(torch.from_numpy(ssl[None]).to(dev))[0].cpu().numpy()

        extract.prepare_semantic(list_file, exp_dir, extract_latent_fn=extract_latent_fn)
        extract.merge_semantic_shards(exp_dir, 1)

    if sv:
        from gpt_sovits_tpu_torch.models.eres2net import kaldi_fbank

        sv_model = load_sv(sv).to(dev).eval()

        @torch.no_grad()
        def sv_fn(w):
            return sv_model(kaldi_fbank(torch.from_numpy(np.asarray(w, np.float32)[None]).to(dev)))[0].float().cpu().numpy()

        extract.prepare_sv(list_file, exp_dir, sv_fn=sv_fn)
    log("prepare done:", exp_dir)


def latest_step_model(directory: str, ext: str) -> str:
    """Newest-step weight file in a directory (get_trained_models.py:23
    `get_final_step_model`, the same file-name conventions: `-e15`,
    `_e48_s336`, `step_1000`, `_1000.`); "" when there is none."""
    import re

    if not os.path.isdir(directory):
        return ""
    best, best_step = "", -1
    for f in sorted(os.listdir(directory)):
        if not f.endswith(ext):
            continue
        step = -1
        m = re.search(r"_e(\d+)_s(\d+)", f)
        if m:
            step = int(m.group(2))
        else:
            m = re.search(r"-e(\d+)", f) or re.search(r"step_(\d+)", f) or re.search(r"_(\d+)\.", f)
            if m:
                step = int(m.group(1))
        if step > best_step:
            best, best_step = os.path.join(directory, f), step
    return best


def _resume(ckpt_dir: str, device, log) -> Optional[dict]:
    from gpt_sovits_tpu_torch.train import ckpt as ckpt_io

    latest = ckpt_io.latest_checkpoint(ckpt_dir)
    if latest is None:
        return None
    log("resumed from", latest)
    return dict(ckpt_io.load_checkpoint(latest, map_location=device), path=latest)


def run_train_s1(exp_dir: str, ckpt_dir: str, *, batch_size: int = 8, epochs: int = 15, save_every: int = 5,
                 dpo: bool = False, pretrained_s1: Optional[str] = None, model_cfg=None,
                 seed: int = 1234, data_parallel: bool = False, device=None,
                 log: Callable[..., None] = print) -> dict:
    """S1 AR text -> semantic training (reference s1_train.py): AdamW behind
    MultiSteps(grad_accum), DPO when `dpo`. -> {"step", "epoch",
    "resumed_from", "exports", "metrics", "models"}: micro-steps and epochs
    done, the checkpoint resumed, the files written, the last micro-step's
    metrics, and the trained model ({"s1": T2SDecoder})."""
    from gpt_sovits_tpu_torch import resolve_device
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
    from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
    from gpt_sovits_tpu_torch.train.data import S1Dataset, batch_to, data_iterator
    from gpt_sovits_tpu_torch.train.s1_train import make_optimizer, make_train_step
    from gpt_sovits_tpu_torch.utils.config import S1Config, TrainConfig
    from gpt_sovits_tpu_torch.utils.metrics import MetricsLogger

    world, rank = _dp_world(data_parallel, batch_size)
    dev = resolve_device(device)
    cfg = model_cfg or S1Config()
    tc = TrainConfig(batch_size=batch_size, epochs=epochs, grad_accum=4, seed=seed)
    ds = S1Dataset(exp_dir, bert_dim=cfg.bert_dim)
    sampler, _ = _sampler(ds.lengths(), tc.batch_size, tc.seed, world, rank)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(tc.seed)
        model = T2SDecoder(cfg)
    model.to(dev)
    _check_f32(model)
    opt = make_optimizer(model.parameters(), tc)
    step, start_epoch, exports = 0, 0, []
    state = _resume(ckpt_dir, dev, log)
    if state is not None:
        model.load_state_dict(state["models"]["s1"])
        opt.load_state_dict(state["optimizers"]["s1"])
        step, start_epoch = state["step"], state["epoch"]
    elif pretrained_s1:
        ck = ckpt_io.load_torch_checkpoint(pretrained_s1)
        model.load_state_dict({k.removeprefix("model."): v for k, v in ck.get("weight", ck).items()})
        log("loaded pretrained", pretrained_s1)
    train_step = make_train_step(model, opt, use_dpo=dpo)
    mlog = MetricsLogger(os.path.join(ckpt_dir, "logs"), echo=False) if rank == 0 else None
    metrics = {}
    try:
        for epoch in range(start_epoch, tc.epochs):
            gen = epoch_generator(tc.seed, epoch, rank)
            for batch in data_iterator(ds, sampler, epoch):
                metrics = train_step(batch_to(batch, dev), gen)
                step += 1
            metrics = {k: float(v) for k, v in metrics.items()}
            if rank:
                continue
            log(f"epoch {epoch}: loss={metrics['loss']:.3f} acc={metrics['acc']:.3f}")
            mlog.log(step, **metrics)
            if (epoch + 1) % save_every == 0:
                ckpt_io.save_checkpoint({"step": step, "epoch": epoch + 1, "models": {"s1": model.state_dict()},
                                         "optimizers": {"s1": opt.state_dict()}}, ckpt_dir, step)
                sd = model.state_dict()
                info = f"{epoch + 1}epoch"
                exports.append(ckpt_io.export_weights(sd, os.path.join(ckpt_dir, f"s1-e{epoch + 1}.npz"),
                                                      config={"model": "s1"}, info=info))
                # the reference's weights-only fp16 export (s1_train.py my_model_ckpt)
                exports.append(ckpt_io.save_reference_pth(sd, os.path.join(ckpt_dir, f"s1-e{epoch + 1}.ckpt"),
                                                          config={"model": {"t2s": "gpt_sovits_tpu_torch"}},
                                                          info=info))
    finally:
        if mlog is not None:
            mlog.close()
    log("train-s1 done")
    return {"step": step, "epoch": tc.epochs, "resumed_from": state and state["path"], "exports": exports,
            "metrics": metrics, "models": {"s1": model}}


def run_train_s2(exp_dir: str, ckpt_dir: str, *, version: str = "v2", batch_size: int = 8, epochs: int = 8,
                 save_every: int = 4, pretrained_s2g: Optional[str] = None, pretrained_s2d: Optional[str] = None,
                 model_cfg=None, seed: int = 1234, data_parallel: bool = False, device=None,
                 log: Callable[..., None] = print) -> dict:
    """S2 SoVITS GAN training (reference s2_train.py) for v1/v2/v2Pro/
    v2ProPlus; the MPD takes periods 17 and 23 too for the Pro versions.
    -> {"step", "epoch", "resumed_from", "exports", "metrics", "models"} as
    run_train_s1, the models {"g": SynthesizerTrn, "d": the discriminator}."""
    from gpt_sovits_tpu_torch import resolve_device
    from gpt_sovits_tpu_torch.models.discriminators import MultiPeriodDiscriminator, periods_for
    from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
    from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
    from gpt_sovits_tpu_torch.train.data import S2Dataset, batch_to, data_iterator
    from gpt_sovits_tpu_torch.train.s2_train import make_optimizer_d, make_optimizer_g, make_train_step
    from gpt_sovits_tpu_torch.utils.config import MelConfig, TrainConfig, s2_config_for_version
    from gpt_sovits_tpu_torch.utils.metrics import MetricsLogger

    world, rank = _dp_world(data_parallel, batch_size)
    dev = resolve_device(device)
    s2 = model_cfg or s2_config_for_version(version)
    tc = TrainConfig(batch_size=batch_size, epochs=epochs, seed=seed)
    mel = MelConfig()
    ds = S2Dataset(exp_dir, version=version, mel_cfg=mel)
    sampler, n_batches = _sampler(ds.lengths(), tc.batch_size, tc.seed, world, rank)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(tc.seed)
        gen = SynthesizerTrn(s2, posterior=True)
        disc = MultiPeriodDiscriminator(periods_for(s2))
    gen.to(dev)
    disc.to(dev)
    _check_f32(gen, disc)
    opt_g = make_optimizer_g(gen, tc, n_batches)
    opt_d = make_optimizer_d(disc, tc, n_batches)
    step, start_epoch, exports = 0, 0, []
    state = _resume(ckpt_dir, dev, log)
    if state is not None:  # s2_train.py:206-231
        gen.load_state_dict(state["models"]["g"])
        disc.load_state_dict(state["models"]["d"])
        opt_g.load_state_dict(state["optimizers"]["g"])
        opt_d.load_state_dict(state["optimizers"]["d"])
        step, start_epoch = state["step"], state["epoch"]
    else:  # resume-else-pretrained, s2_train.py:232-275
        if pretrained_s2g:
            ck = ckpt_io.load_torch_checkpoint(pretrained_s2g)
            missing, unexpected = gen.load_state_dict(ck.get("weight", ck), strict=False)
            if unexpected or any(not k.startswith("enc_q.") for k in missing):
                raise ValueError(f"{pretrained_s2g}: missing {missing}, unexpected {unexpected}")
            log("loaded pretrained", pretrained_s2g)
        if pretrained_s2d:
            ck = ckpt_io.load_torch_checkpoint(pretrained_s2d)
            disc.load_state_dict(ck.get("weight", ck))
            log("loaded pretrained", pretrained_s2d)
    train_step = make_train_step(gen, disc, opt_g, opt_d, tc, mel)
    mlog = MetricsLogger(os.path.join(ckpt_dir, "logs"), echo=False) if rank == 0 else None
    metrics = {}
    try:
        for epoch in range(start_epoch, tc.epochs):
            rng = epoch_generator(tc.seed, epoch, rank)
            for batch in data_iterator(ds, sampler, epoch):
                metrics = train_step(batch_to(batch, dev), rng)
                step += 1
            metrics = {k: float(v) for k, v in metrics.items()}
            if rank:
                continue
            log(f"epoch {epoch}: " + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()))
            mlog.log(step, **metrics)
            if (epoch + 1) % save_every == 0:
                ckpt_io.save_checkpoint({"step": step, "epoch": epoch + 1,
                                         "models": {"g": gen.state_dict(), "d": disc.state_dict()},
                                         "optimizers": {"g": opt_g.state_dict(), "d": opt_d.state_dict()}},
                                        ckpt_dir, step)
                ref = ckpt_io.s2_reference_state(gen.state_dict())
                info = f"{epoch + 1}epoch"
                exports.append(ckpt_io.export_weights(ref, os.path.join(ckpt_dir, f"s2G-e{epoch + 1}.npz"),
                                                      config={"version": version}, info=info))
                exports.append(ckpt_io.save_reference_pth(ref, os.path.join(ckpt_dir, f"s2G-e{epoch + 1}.pth"),
                                                          model_version=version, config={"version": version},
                                                          info=info))
    finally:
        if mlog is not None:
            mlog.close()
    log("train-s2 done")
    return {"step": step, "epoch": tc.epochs, "resumed_from": state and state["path"], "exports": exports,
            "metrics": metrics, "models": {"g": gen, "d": disc}, "reads": dict(ds.reads)}


def run_train_v3(exp_dir: str, ckpt_dir: str, *, version: str = "v3", batch_size: int = 4, epochs: int = 4,
                 save_every: int = 2, lora_rank: int = 0, pretrained: Optional[str] = None, model_cfg=None,
                 seed: int = 1234, data_parallel: bool = False, device=None,
                 log: Callable[..., None] = print) -> dict:
    """v3/v4 CFM fine-tune (reference s2_train_v3.py), or LoRA on the DiT's
    attention projections when lora_rank > 0 (s2_train_v3_lora.py). The
    exports hold the merged weights, with {"lora_rank": r} in `config` for
    LoRA runs. -> {"step", "epoch", "resumed_from", "exports", "metrics",
    "models" ({"s2": SynthesizerTrnV3}), "lora" (the factors, or None),
    "reads" (batches read natively / by Python)}."""
    from gpt_sovits_tpu_torch import resolve_device
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
    from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
    from gpt_sovits_tpu_torch.train.data import V3Dataset, batch_to, data_iterator
    from gpt_sovits_tpu_torch.train.s2_train_v3 import (
        init_lora, make_lora_optimizer, make_lora_train_step, make_optimizer, make_train_step, merge_lora,
    )
    from gpt_sovits_tpu_torch.utils.config import TrainConfig, s2_config_for_version
    from gpt_sovits_tpu_torch.utils.metrics import MetricsLogger

    if version not in ("v3", "v4"):
        raise ValueError(f"run_train_v3 trains v3/v4, got {version!r}")
    world, rank = _dp_world(data_parallel, batch_size)
    dev = resolve_device(device)
    cfg = model_cfg or s2_config_for_version(version)
    tc = TrainConfig(batch_size=batch_size, epochs=epochs, seed=seed)
    ds = V3Dataset(exp_dir, version=version)
    sampler, n_batches = _sampler(ds.lengths(), tc.batch_size, tc.seed, world, rank)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(tc.seed)
        model = SynthesizerTrnV3(cfg)
    model.to(dev)
    _check_f32(model)
    lora = None
    if lora_rank > 0:
        lora = init_lora(model, lora_rank, torch.Generator().manual_seed(tc.seed + 1))
        opt = make_lora_optimizer(lora, tc, n_batches)
    else:
        opt = make_optimizer(model, tc, n_batches)
    step, start_epoch, exports = 0, 0, []
    state = _resume(ckpt_dir, dev, log)
    if state is not None:
        model.load_state_dict(state["models"]["s2"])
        opt.load_state_dict(state["optimizers"]["s2"])
        with torch.no_grad():
            for name, f in (lora or {}).items():
                for k in ("A", "B"):
                    f[k].copy_(state["lora"][name][k])
        step, start_epoch = state["step"], state["epoch"]
    elif pretrained:  # as the JAX package's _overlay_params: what the file lacks keeps its initial value
        ck = ckpt_io.load_torch_checkpoint(pretrained)
        _, unexpected = model.load_state_dict({k: v.float() for k, v in ck.get("weight", ck).items()}, strict=False)
        if unexpected:
            raise ValueError(f"{pretrained}: unexpected {unexpected}")
        log("loaded pretrained", pretrained)
    train_step = make_lora_train_step(model, lora, opt) if lora is not None else make_train_step(model, opt)
    mlog = MetricsLogger(os.path.join(ckpt_dir, "logs"), echo=False) if rank == 0 else None
    extra = {"lora_rank": lora_rank} if lora is not None else {}
    metrics = {}
    try:
        for epoch in range(start_epoch, tc.epochs):
            gen = epoch_generator(tc.seed, epoch, rank)
            for batch in data_iterator(ds, sampler, epoch):
                metrics = train_step(batch_to(batch, dev), gen)
                step += 1
            metrics = {k: float(v) for k, v in metrics.items()}
            if rank:
                continue
            log(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            mlog.log(step, **metrics)
            if (epoch + 1) % save_every == 0:
                lora_sd = {n: {k: t.detach().clone() for k, t in f.items()} for n, f in (lora or {}).items()}
                ckpt_io.save_checkpoint({"step": step, "epoch": epoch + 1, "models": {"s2": model.state_dict()},
                                         "optimizers": {"s2": opt.state_dict()}, "lora": lora_sd or None},
                                        ckpt_dir, step)
                sd = model.state_dict() if lora is None else merge_lora(model.state_dict(), lora)
                ref = ckpt_io.s2_reference_state(sd)
                info = f"{epoch + 1}epoch"
                stem = os.path.join(ckpt_dir, f"s2G-{version}-e{epoch + 1}")
                exports.append(ckpt_io.export_weights(ref, stem + ".npz", config={"version": version, **extra},
                                                      info=info))
                exports.append(ckpt_io.save_reference_pth(ref, stem + ".pth", model_version=version,
                                                          config={"version": version, **extra}, info=info))
    finally:
        if mlog is not None:
            mlog.close()
    log("train-v3 done")
    return {"step": step, "epoch": tc.epochs, "resumed_from": state and state["path"], "exports": exports,
            "metrics": metrics, "models": {"s2": model}, "lora": lora, "reads": dict(ds.reads)}
