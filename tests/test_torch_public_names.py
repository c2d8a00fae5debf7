"""The public names of the JAX package that the port's last slice adds,
each against its JAX counterpart on the CPU: dsp/sola.py `chunk_plan`,
utils/config.py `MeshConfig`, `asdict`, `to_json` and `replace`,
`VQCodebook.encode_with`, utils/metrics.py `ThroughputMeter` (`measure`,
`as_dict`, `audio_s_per_s_per_chip`) and `profile_trace` (a Chrome trace
file on torch.profiler where JAX writes an xprof trace, with the port's
recorded spans of every thread), and
SynthesizerTrnV3b's `compute_ge`, `extract_latent` and `dit_config`."""

import dataclasses
import json
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.dsp import sola as jsola
from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3b as JV3b
from gpt_sovits_tpu.models.vits_modules import VQCodebook as JVQ
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu.utils import metrics as jmetrics
from gpt_sovits_tpu_torch.dsp import sola
from gpt_sovits_tpu_torch.models.vits_modules import VQCodebook
from gpt_sovits_tpu_torch.utils import config, metrics
from test_torch_train_v3b import v3b_setup

torch.set_num_threads(1)


@pytest.mark.parametrize("args", [(0, 100, 934), (1000, 100, 934), (2500, 256, 1024), (834, 100, 934)])
def test_chunk_plan_is_jaxs(args):
    assert sola.chunk_plan(*args) == jsola.chunk_plan(*args)


def test_config_helpers_are_jaxs():
    for name in ("S1Config", "S2Config", "MelConfig", "TrainConfig", "MeshConfig"):
        assert config.to_json(getattr(config, name)()) == jconfig.to_json(getattr(jconfig, name)()), name
        assert config.asdict(getattr(config, name)()) == jconfig.asdict(getattr(jconfig, name)()), name
    assert config.to_json(config.s2_config_for_version("v4")) == jconfig.to_json(jconfig.s2_config_for_version("v4"))
    c = config.replace(config.MeshConfig(), model_parallel=2)
    assert c.model_parallel == 2 and c.data_parallel == -1 and dataclasses.is_dataclass(c)


def test_encode_with_is_jaxs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    embed = rng.standard_normal((40, 16)).astype(np.float32)
    want = np.asarray(JVQ.encode_with(jnp.asarray(x), jnp.asarray(embed)))
    got = VQCodebook.encode_with(torch.from_numpy(x), torch.from_numpy(embed))
    np.testing.assert_array_equal(got.numpy(), want)


def test_throughput_meter_is_jaxs():
    ours, theirs = metrics.ThroughputMeter(n_chips=2), jmetrics.ThroughputMeter(n_chips=2)
    for m in (ours, theirs):
        m.measure_done(3.0, 1.5)
        m.measure_done(5.0, 0.5)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.audio_s_per_s_per_chip == theirs.audio_s_per_s_per_chip == 2.0
    with ours.measure(audio_seconds=4.0):
        sum(range(1000))
    assert ours.audio_seconds == 12.0 and ours.wall_seconds > 2.0


def test_profile_trace_writes_a_trace(tmp_path):
    """The Chrome trace holds the profiler's events and the recorder's spans
    of every thread over the block, on the profiler's clock: a span from a
    second thread lies between the block's first and last profiled event."""
    def worker(tid):
        tid.append(threading.get_native_id())
        with metrics.recorder().span("test.second_thread", 5):
            time.sleep(0.005)

    try:
        tid = []
        with metrics.profile_trace(str(tmp_path / "trace")) as prof:
            torch.randn(64, 64) @ torch.randn(64, 64)
            th = threading.Thread(target=worker, args=(tid,))
            th.start()
            th.join(timeout=60)
            torch.randn(8) + 1
        assert prof is not None and not th.is_alive()
        trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
        assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])
        spans = [e for e in trace["traceEvents"] if e.get("name") == "test.second_thread"]
        assert len(spans) == 1 and spans[0]["tid"] == tid[0] != threading.get_native_id()
        assert spans[0]["args"]["rid"] == 5 and spans[0]["dur"] >= 5000
        ops = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
        mm = min(e["ts"] for e in ops if "mm" in e["name"])
        add = max(e["ts"] + e["dur"] for e in ops if e["name"] == "aten::add")
        assert mm < spans[0]["ts"] and spans[0]["ts"] + spans[0]["dur"] < add
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_v3b_compute_ge_extract_latent_dit_config_are_jaxs():
    jcfg, jm, params, pm, bn = v3b_setup()
    spec = bn["spec"]
    mask = (np.arange(spec.shape[1])[None, :] < bn["spec_lengths"][:, None]).astype(np.float32)
    want = jm.apply(params, jnp.asarray(spec), jnp.asarray(mask[..., None]), method=JV3b.compute_ge)  # JAX: (B, T, 1)
    with torch.no_grad():
        got = pm.compute_ge(torch.from_numpy(spec), torch.from_numpy(mask))
        codes = pm.extract_latent(torch.from_numpy(bn["ssl"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5 * np.abs(np.asarray(want)).max())
    want_codes = jm.apply(params, jnp.asarray(bn["ssl"]), method=JV3b.extract_latent)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    assert dataclasses.asdict(pm.dit_config) == dataclasses.asdict(jm.dit_config)
