"""Worker of tests/test_torch_mesh.py: one process of a (data, model) =
(1, 2) mesh on the CPU (gloo), or, without a port, the one-process
reference.

    python torch_tp_worker.py <out.pt> <port> <rank>

Runs S1's full-sequence forward, one S2 G+D step and one S1 update (two
micro-steps, the global-norm clip on) at tiny widths from seeded weights,
the models under parallel/mesh.py shard_params: the tiny configs keep one
width at 512 (S1's ffn_dim, S2's upsample_initial_channel; the MPD's convs
are full width) so that the rule shards something; and a 512-wide VQ
codebook's encode, decode and gradient (a raw parameter, gathered where it
is read). The result, with the
whole (gathered) gradients and parameter changes, is torch.save'd to
<out.pt>.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import torch_dp_worker as dp
from gpt_sovits_tpu_torch.models.discriminators import MultiPeriodDiscriminator, periods_for
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, build_prefix_attn_bias
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.parallel import mesh as tp
from gpt_sovits_tpu_torch.train import s1_train, s2_train
from gpt_sovits_tpu_torch.utils import config

S1 = dict(dp.S1, ffn_dim=512)  # linear1 (512 out) shards
S2 = dict(dp.S2, upsample_initial_channel=512)  # conv_pre and cond (512 out) shard


def _shard(models, mesh):
    for m in models:
        if mesh is not None:
            tp.shard_params(m, mesh)
    return models


def _whole(models, grads: bool = False) -> dict:
    return {f"{i}.{k}": v for i, m in enumerate(models) for k, v in tp.gather_params(m, grads).items()}


def _result(models, metrics, before: dict) -> dict:
    after = _whole(models)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: v for k, v in _whole(models, grads=True).items() if v is not None},
            "change": {k: v - before[k] for k, v in after.items()}}


def s1_forward(mesh) -> torch.Tensor:
    rng = np.random.default_rng(4)
    torch.manual_seed(4)
    (model,) = _shard([T2SDecoder(config.S1Config(**S1))], mesh)
    xy = torch.from_numpy(rng.standard_normal((2, 12, S1["embedding_dim"])).astype(np.float32))
    x_valid = torch.ones((2, 5), dtype=torch.bool)
    y_valid = torch.from_numpy(np.arange(7)[None, :] < np.asarray([[7], [4]]))
    with torch.no_grad():
        return model(xy, build_prefix_attn_bias(x_valid, y_valid))


def s2_step(mesh) -> dict:
    """dp.s2_step's G+D step on the whole batch."""
    rng = np.random.default_rng(0)
    t = 20
    batch = {
        "ssl": rng.standard_normal((dp.GB, 2 * t, S2["ssl_dim"])).astype(np.float32),
        "spec": (rng.standard_normal((dp.GB, t, S2["spec_channels"])) * 0.3 + 1.0).astype(np.float32),
        "spec_lengths": np.asarray([t, t - 3, t - 1, t - 5]),
        "wav": (rng.standard_normal((dp.GB, t * dp.MEL["hop_size"], 1)) * 0.1).astype(np.float32),
        "text": rng.integers(0, 700, (dp.GB, 6)),
        "text_lengths": np.asarray([6, 4, 5, 3]),
        "sv_emb": rng.standard_normal((dp.GB, S2["sv_dim"])).astype(np.float32),
    }
    noise = torch.from_numpy(rng.standard_normal((dp.GB, t, S2["inter_channels"])).astype(np.float32))
    starts = torch.from_numpy(np.asarray([3, 0, 7, 2]))
    cfg = config.S2Config(**S2)
    torch.manual_seed(0)
    models = _shard([SynthesizerTrn(cfg, posterior=True), MultiPeriodDiscriminator(periods_for(cfg)[:2])], mesh)
    gen, disc = models
    tc = config.TrainConfig(batch_size=dp.GB)
    step = s2_train.make_train_step(gen, disc, s2_train.make_optimizer_g(gen, tc, 4),
                                    s2_train.make_optimizer_d(disc, tc, 4), tc, config.MelConfig(**dp.MEL))
    before = _whole(models)
    m = step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, noise=noise, ids_slice=starts)
    return _result(models, m, before)


def s1_update(mesh) -> dict:
    """One S1 update of two micro-steps (DPO off) with the global-norm clip."""
    rng = np.random.default_rng(1)
    tx, ty = 12, 20
    torch.manual_seed(1)
    (model,) = _shard([T2SDecoder(config.S1Config(**S1))], mesh)
    opt = s1_train.make_optimizer(model.parameters(), config.TrainConfig(grad_accum=2, warmup_steps=10, grad_clip=0.05))
    step = s1_train.make_train_step(model, opt)
    before = _whole([model])
    for _ in range(2):
        b = {"phoneme_ids": rng.integers(0, S1["phoneme_vocab_size"], (dp.GB, tx)),
             "phoneme_lens": rng.integers(5, tx + 1, dp.GB), "semantic_ids": rng.integers(0, S1["eos_id"], (dp.GB, ty)),
             "semantic_lens": rng.integers(8, ty + 1, dp.GB),
             "bert_features": rng.standard_normal((dp.GB, tx, S1["bert_dim"])).astype(np.float32)}
        m = step({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
    assert opt.updates == 1
    return _result([model], {"loss": m["loss"]}, before)


def codebook(mesh) -> dict:
    """VQCodebook(40, 512): the codes of some rows, and the gradient of a
    loss through the decoded rows into the (sharded) table."""
    from gpt_sovits_tpu_torch.models.vits_modules import VQCodebook

    torch.manual_seed(5)
    (vq,) = _shard([VQCodebook(40, 512)], mesh)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 7, 512)).astype(np.float32))
    codes = vq.encode(x)
    loss = ((vq.decode(codes) - x) ** 2).sum()
    loss.backward()
    return {"codes": codes, "loss": float(loss), "grad": tp.gather_params(vq, grads=True)["vq.layers.0._codebook.embed"],
            "local": {n: tuple(p.shape) for n, p in vq.named_parameters()}}


def sharded_shapes(mesh) -> dict:
    """This rank's shapes of the sharded parameters of the S1 and S2 models."""
    s1 = _shard([T2SDecoder(config.S1Config(**S1))], mesh)[0]
    s2 = _shard([SynthesizerTrn(config.S2Config(**S2), posterior=True)], mesh)[0]
    return {k: {n: tuple(p.shape) for n, p in m.named_parameters() if hasattr(p, "tp_dim")}
            for k, m in (("s1", s1), ("s2", s2))}


def run(mesh) -> dict:
    return {"s1_forward": s1_forward(mesh), "s2": s2_step(mesh), "s1": s1_update(mesh), "codebook": codebook(mesh)}


def main(out: str, port: int, rank: int) -> None:
    from gpt_sovits_tpu_torch.parallel import launch

    sys.modules["torch.utils.tensorboard"] = None
    torch.set_num_threads(1)
    launch.init(f"tcp://127.0.0.1:{port}", 2, rank, device="cpu")
    try:
        mesh = tp.make_mesh(1, 2, device="cpu")
        with tp.data_parallel(mesh):
            res = run(mesh)
        res["sharded"] = sharded_shapes(mesh)
        res["mesh"] = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
                       "model_rank": mesh.get_local_rank("model"), "data_rank": mesh.get_local_rank("data")}
    finally:
        launch.shutdown()
    torch.save(res, out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
