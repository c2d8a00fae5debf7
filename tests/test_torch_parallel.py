"""Data parallelism in the port (parallel/launch.py, parallel/sync.py, the
trainers' data_parallel=True) on the CPU: two gloo processes, each on half
of one global batch, take the same S2 G+D step, S1 update (DPO on, two
micro-steps of accumulation) and v3 CFM step as one process on the whole
batch, and keep the VQ EMA codebook statistics global; rank 0 alone writes; a world of one runs as without data
parallelism; a batch that the world does not divide is refused. The
processes are started with subprocess under a timeout and killed on
expiry (tests/torch_dp_worker.py)."""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import torch_dp_worker as worker
from gpt_sovits_tpu_torch.parallel import launch, sync
from gpt_sovits_tpu_torch.run import run_train_s1, run_train_s2, run_train_v3
from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
from gpt_sovits_tpu_torch.utils import config

ROOT = Path(__file__).resolve().parents[1]
BAR = 1e-5  # relative L2: the ranks' summed halves against the whole batch, float32
TIMEOUT = 240  # seconds for the two processes
# parameters whose gradient is zero in exact arithmetic (key biases: softmax
# is shift-invariant): their float gradient is rounding noise, which differs
# with the order of the sums, and Adam's first step follows its sign
ZERO_GRAD = (".conv_k.bias", ".w_ks.bias", ".to_k.bias", ".in_proj_bias")
# Adam's first step moves an element by lr * g / (|g| + eps), so where |g| is
# near eps (1e-9) the change follows g's last digits, which the order of the
# sums sets; changes are compared where |g| > WELL_CONDITIONED (1000 x eps)
WELL_CONDITIONED = 1e-6
QUIET = dict(log=lambda *a, **k: None)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _corpus(path) -> str:
    chip_smoke.write_corpus(path, (1.4,) * 2 + (1.5,) * 2, seed=5, ssl_dim=worker.V3["ssl_dim"], sv=False)
    return str(path)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL only (test_torch_train_data.py)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two workers' results; their corpus and dumps (`r0.pt`, `r1.pt`,
    ~550 MB each: full-width discriminator gradients and moments) are
    deleted when the module's tests end, passed or failed."""
    tmp = tmp_path_factory.mktemp("dp")
    try:
        corpus = _corpus(tmp / "exp")
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
        procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dp_worker.py"), str(tmp / f"r{r}.pt"),
                                   str(port), "2", str(r), corpus], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            pytest.fail("the data-parallel workers did not finish in time")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
        yield [torch.load(tmp / f"r{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def one_process():
    return {"s2": worker.s2_step(1, 0), "s1": worker.s1_step(1, 0), "v3": worker.v3_step(1, 0)}


@pytest.mark.parametrize("trainer", ["s2", "s1", "v3"])
def test_two_ranks_take_the_global_batch_step(two_ranks, one_process, trainer):
    ref = one_process[trainer]
    for rank, res in enumerate(two_ranks):
        got = res[trainer]
        assert got["metrics"].keys() == ref["metrics"].keys()
        for k, v in ref["metrics"].items():
            assert rel(got["metrics"][k], v) < BAR, (trainer, rank, k, got["metrics"][k], v)
        assert got["grads"].keys() == ref["grads"].keys() and got["change"].keys() == ref["change"].keys()
        for name, change in ref["change"].items():
            if name.endswith(ZERO_GRAD):
                continue
            if name not in ref["grads"]:  # frozen: no gradient, no change
                assert not got["change"][name].any() and not change.any(), (trainer, name)
                continue
            assert rel(got["grads"][name], ref["grads"][name]) < BAR, (trainer, name)
            sure = ref["grads"][name].abs() > WELL_CONDITIONED
            assert rel(got["change"][name][sure], change[sure]) < BAR, (trainer, name)
    for name, v in two_ranks[0][trainer]["change"].items():  # the replicas stay equal
        assert torch.equal(v, two_ranks[1][trainer]["change"][name]), (trainer, name)


def test_vq_ema_counts_and_sums_are_global(two_ranks):
    ref = worker.vq_ema(1, 0)
    for res in two_ranks:
        for k, v in ref.items():
            assert rel(res["vq"][k], v) < BAR, k


def test_rank0_alone_writes(two_ranks):
    r0, r1 = (r["entry"] for r in two_ranks)
    assert sorted(r0["written"]) == ["export_weights", "save_checkpoint", "save_reference_pth"] and r1["written"] == []
    assert len(r0["exports"]) == 2 and r1["exports"] == [] and r0["step"] == r1["step"] == 1
    for name, v in r0["params"].items():
        assert torch.equal(v, r1["params"][name]), name
    assert [r["host"]["process_index"] for r in two_ranks] == [0, 1]
    assert all(r["host"]["process_count"] == 2 for r in two_ranks)
    assert two_ranks[0]["shard"] == list(range(0, 10, 2)) and two_ranks[1]["shard"] == list(range(1, 10, 2))


def test_world_of_one_runs_as_without_data_parallel(tmp_path):
    """S1 with DPO and 4-step accumulation: one update from 4 micro-steps."""
    chip_smoke.write_corpus(tmp_path / "exp", (1.4,) * 4, seed=6, ssl_dim=8, sv=False)
    s1 = dict(worker.S1, bert_dim=1024, phoneme_vocab_size=732, vocab_size=1025, eos_id=1024)
    kw = dict(batch_size=2, epochs=2, save_every=2, dpo=True, model_cfg=config.S1Config(**s1), device="cpu", **QUIET)
    launch.init()  # one process: nothing to join
    assert sync.world() == 1 and launch.host_info()["process_count"] == 1
    run_train_s1(str(tmp_path / "exp"), str(tmp_path / "dp"), data_parallel=True, **kw)
    run_train_s1(str(tmp_path / "exp"), str(tmp_path / "plain"), data_parallel=False, **kw)
    a, b = (ckpt_io.load_checkpoint(ckpt_io.latest_checkpoint(str(tmp_path / d))) for d in ("dp", "plain"))
    assert a["optimizers"]["s1"]["updates"] == 1
    for k, v in a["models"]["s1"].items():
        assert torch.equal(v, b["models"]["s1"][k]), k
    assert launch.host_shard(list(range(5))) == list(range(5))


def test_batch_must_divide_the_world(tmp_path, monkeypatch):
    monkeypatch.setattr(sync, "world", lambda: 2)
    for fn in (run_train_s1, run_train_s2, run_train_v3):
        with pytest.raises(ValueError, match="not divisible by 2"):
            fn(str(tmp_path / "none"), str(tmp_path / "c"), batch_size=3, data_parallel=True, device="cpu", **QUIET)
    assert not (tmp_path / "c").exists()


def test_a_process_group_needs_data_parallel(tmp_path, monkeypatch):
    """The steps sum over any group, so a trainer in one runs only as data parallel."""
    monkeypatch.setattr(sync, "world", lambda: 2)
    for fn in (run_train_s1, run_train_s2, run_train_v3):
        with pytest.raises(ValueError, match="pass data_parallel=True"):
            fn(str(tmp_path / "none"), str(tmp_path / "c"), batch_size=4, data_parallel=False, device="cpu", **QUIET)
    assert not (tmp_path / "c").exists()
