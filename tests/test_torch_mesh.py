"""The tensor-parallel rules of the port (gpt_sovits_tpu_torch/parallel/mesh.py)
against the JAX package's (gpt_sovits_tpu/parallel/mesh.py) on the CPU.

* The rule, leaf by leaf, at full width (S1Config(), S2 v2ProPlus with its
  posterior encoder, the v4 SynthesizerTrnV3, BigVGANConfig()), shapes only
  (jax.eval_shape): each JAX leaf is filled with codes i + K * j (i the
  leaf's number of K, j the index along the axis param_pspec shards, 0 for a
  replicated leaf), carried into the port by weights.py, and each port
  parameter's placement must shard the same values: its chunks along the
  port's dim hold exactly the JAX chunks' indices, at 2 and 4 model ranks;
  a replicated leaf stays replicated.
* Two gloo ranks on a (1, 2) mesh (tests/torch_tp_worker.py, started as
  tests/test_torch_parallel.py starts its workers) take S1's forward, one
  S2 G+D step and one S1 update with the clip as one process does, within
  1e-5: the losses, the gradients and the parameter changes; a 512-wide VQ
  codebook (a raw parameter, gathered where it is read) gives the same
  codes, loss and gradient.
* One process: a (1, 1) mesh, shard_params leaves the forward as it was;
  shard_batch and the placements of single layers.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import Replicate, Shard

import torch_tp_worker as worker
from gpt_sovits_tpu.models.bigvgan import BigVGAN as JBigVGAN, BigVGANConfig as JBigVGANConfig
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3 as JV3
from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.parallel.mesh import param_pspec
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.parallel import mesh as tp
from gpt_sovits_tpu_torch.utils import config

ROOT = Path(__file__).resolve().parents[1]
BAR = 1e-5  # relative L2: two model ranks against one process, float32
TIMEOUT = 240  # seconds for the two processes
ZERO_GRAD = (".conv_k.bias", ".w_ks.bias", ".to_k.bias", ".in_proj_bias")  # test_torch_parallel.py's
WELL_CONDITIONED = 1e-6  # test_torch_parallel.py's: changes compared where |g| > 1000 x Adam's eps


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the rule at full width
# ---------------------------------------------------------------------------

KEYS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0), "slice": jax.random.PRNGKey(0)}


def _s1():
    cfg = jconfig.S1Config()
    return (lambda: JT2S(cfg).init(jax.random.PRNGKey(0), method=JT2S.init_all),
            lambda: T2SDecoder(config.S1Config()), lambda p: weights.s1_from_jax(p, config.S1Config()))


def _s2():
    jc, pc = jconfig.s2_config_for_version("v2ProPlus"), config.s2_config_for_version("v2ProPlus")
    init = lambda: JSynth(jc).init(  # noqa: E731
        KEYS, jnp.zeros((1, 80, jc.ssl_dim)), jnp.zeros((1, 40, jc.spec_channels)), jnp.asarray([40]),
        jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]), sv_emb=jnp.zeros((1, jc.sv_dim)), method=JSynth.init_all)
    return init, lambda: SynthesizerTrn(pc, posterior=True), lambda p: weights.s2_from_jax(p, pc)


def _v4():
    jc, pc = jconfig.s2_config_for_version("v4"), config.s2_config_for_version("v4")
    init = lambda: JV3(jc).init(  # noqa: E731
        KEYS, jnp.zeros((1, 16, jc.ssl_dim)), jnp.zeros((1, 16, jc.spec_channels)), jnp.asarray([16]),
        jnp.zeros((1, 30, jc.cfm_mel_channels)), jnp.asarray([30]), jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        method=JV3.init_all)
    return init, lambda: SynthesizerTrnV3(pc), lambda p: weights.s2v3_from_jax(p, pc)


def _bigvgan():
    init = lambda: JBigVGAN(JBigVGANConfig()).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 100)))  # noqa: E731
    return init, lambda: BigVGAN(BigVGANConfig()), lambda p: weights.bigvgan_from_jax(p, BigVGANConfig())


MODELS = {"s1": _s1, "s2_v2ProPlus": _s2, "v4": _v4, "bigvgan": _bigvgan}


def coded_tree(shapes):
    """Each leaf i of K filled with i + K * (its index along the axis
    param_pspec shards, or 0) -> (tree, [(axis or None, shape)] by leaf)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    k = len(leaves)
    arrs, specs = [], []
    for i, (path, s) in enumerate(leaves):
        spec = tuple(param_pspec(path, s))
        a = spec.index("model") if "model" in spec else None
        if a is None:
            arr = np.broadcast_to(np.float32(i), s.shape)
        else:
            shape = [1] * len(s.shape)
            shape[a] = -1
            arr = np.broadcast_to((np.arange(s.shape[a], dtype=np.float32) * k + i).reshape(shape), s.shape)
        assert k * (s.shape[a] if a is not None else 1) < 2**24  # exact in float32
        arrs.append(arr)
        specs.append((a, tuple(s.shape)))
    return jax.tree_util.tree_unflatten(treedef, arrs), specs, k


@pytest.mark.parametrize("model", sorted(MODELS))
def test_rule_shards_the_axis_jax_shards(model):
    init, build, convert = MODELS[model]()
    tree, specs, k = coded_tree(jax.eval_shape(init))
    sd = convert(tree)
    del tree
    with torch.device("meta"):
        port = build()
    owners = dict(port.named_modules())
    n_sharded = 0
    for name, p in port.named_parameters():
        owner_name, _, pname = name.rpartition(".")
        v = sd.get(name)
        if v is None:  # a weight-norm pair: weight_v holds the weight's values
            v = sd[name[: -len("weight")] + "weight_v"]
        codes = v.reshape(p.shape).int()  # the codes are below 2**24
        leaf = codes % k
        i = int(leaf.reshape(-1)[0])
        assert bool((leaf == i).all()), (name, "values of several JAX leaves")
        a, shape = specs[i]
        d = tp.shard_dim(tp.param_placement(name, p, owners[owner_name]))
        if a is None:
            assert d is None, (name, "sharded in the port, replicated in JAX", tuple(p.shape))
            continue
        assert d is not None, (name, "replicated in the port, sharded in JAX", tuple(p.shape), shape, a)
        n_sharded += 1
        idx = codes // k
        for n in (2, 4):
            step = shape[a] // n
            for r, chunk in enumerate(idx.chunk(n, d)):
                assert (int(chunk.min()), int(chunk.max())) == (r * step, (r + 1) * step - 1), (name, n, r, d, a)
    assert n_sharded > 0


def test_placements_of_single_layers():
    cases = [
        (nn.Linear(1024, 2048), "weight", (Replicate(), Shard(0))),
        (nn.Linear(1024, 2048), "bias", (Replicate(), Replicate())),
        (nn.Linear(512, 511), "weight", (Replicate(), Replicate())),  # odd width
        (nn.Conv1d(64, 512, 3), "weight", (Replicate(), Shard(0))),
        (nn.Conv1d(1024, 1024, 41, groups=256), "weight", (Replicate(), Shard(0))),
        (nn.ConvTranspose1d(512, 256, 16), "weight", (Replicate(), Replicate())),  # 256 output channels
        (nn.ConvTranspose1d(256, 1024, 16), "weight", (Replicate(), Shard(1))),
        (nn.Embedding(100, 512), "weight", (Replicate(), Shard(1))),
        (nn.Embedding(5000, 256), "weight", (Replicate(), Shard(0))),  # a table of >= 4096 rows
        (nn.LayerNorm(1024), "weight", (Replicate(), Replicate())),
    ]
    for layer, name, want in cases:
        assert tp.param_placement(name, getattr(layer, name), layer) == want, (layer, name)
    assert tp.batch_sharding(None) == (Shard(0), Replicate()) and tp.replicated(None) == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# one process: a (1, 1) mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def one_process_mesh():
    try:
        yield tp.make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_one_process_mesh_runs_as_without_it(one_process_mesh):
    mesh = one_process_mesh
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    ref = worker.s1_forward(None)
    got = worker.s1_forward(mesh)
    assert torch.equal(got, ref)
    batch = {"x": torch.arange(8).reshape(4, 2), "n": torch.tensor(3), "name": "b"}
    assert tp.shard_batch(batch, mesh)["x"].shape == (4, 2) and tp.shard_batch(batch, mesh)["name"] == "b"
    with pytest.raises(ValueError):
        tp.make_mesh(2, 1, device="cpu")  # 2 ranks in a world of 1


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    try:
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
        procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_tp_worker.py"), str(tmp / f"r{r}.pt"),
                                   str(port), str(r)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            pytest.fail("the tensor-parallel workers did not finish in time")
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
def one_process(monkeypatch_module):
    return worker.run(None)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL only (test_torch_train_data.py)
    yield mp
    mp.undo()


def test_two_ranks_share_the_model_axis(two_ranks):
    assert [r["mesh"]["model_rank"] for r in two_ranks] == [0, 1]
    assert all(r["mesh"]["shape"] == (1, 2) and r["mesh"]["data_rank"] == 0 for r in two_ranks)
    for r in two_ranks:  # each rank held half of the sharded weights
        assert r["sharded"]["s1"]["h.layers.0.linear1.weight"] == (256, worker.S1["hidden_dim"])
        assert r["sharded"]["s2"]["dec.conv_pre.weight"] == (256, worker.S2["inter_channels"], 7)
        # the codebook's rows are read whole (encode's distances): a parametrization gathers them
        assert r["codebook"]["local"] == {"vq.layers.0._codebook.parametrizations.embed.original": (40, 256)}


def test_two_ranks_s1_forward(two_ranks, one_process):
    for r in two_ranks:
        assert rel(r["s1_forward"], one_process["s1_forward"]) < BAR


def test_two_ranks_gather_a_raw_parameter(two_ranks, one_process):
    ref = one_process["codebook"]
    for r in two_ranks:
        assert torch.equal(r["codebook"]["codes"], ref["codes"])
        assert rel(r["codebook"]["loss"], ref["loss"]) < BAR and rel(r["codebook"]["grad"], ref["grad"]) < BAR


@pytest.mark.parametrize("trainer", ["s2", "s1"])
def test_two_ranks_take_the_one_process_step(two_ranks, one_process, trainer):
    ref = one_process[trainer]
    for rank, res in enumerate(two_ranks):
        got = res[trainer]
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
