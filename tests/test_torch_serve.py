"""The port's serving path on the CPU: the pipeline's auxiliary references
and recover(), the continuous service (serve/continuous_service.py) and
the api_v2 HTTP server (serve/api.py, serve/gui_client.py), each held
against the JAX package's on the tiny v2ProPlus pipelines of
test_torch_pipeline (same weights, a 1 s reference as test_serve.py uses).
Greedy requests compare audio: the service with the port's `run` sample
for sample, the port with the JAX package within 1 LSB of int16."""

import dataclasses
import json
import struct
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from gpt_sovits_tpu.dsp.audio_io import save_wav
from gpt_sovits_tpu.serve.api import TTSService as JTTSService
from gpt_sovits_tpu.serve.continuous_service import ContinuousTTSService as JService
from gpt_sovits_tpu_torch.infer.continuous import ContinuousBatcher
from gpt_sovits_tpu_torch.serve import api as api_mod
from gpt_sovits_tpu_torch.serve.api import TTSService, serve, wav_bytes
from gpt_sovits_tpu_torch.serve.continuous_service import ContinuousTTSService
from gpt_sovits_tpu_torch.utils.metrics import recorder
from test_torch_pipeline import pipes  # noqa: F401  (the tiny pipelines, one pair for this module)

torch.set_num_threads(1)

LSB = 1  # int16 steps between the port's and the JAX package's audio
POOL = dict(slots=2, segment=8, tx_max=64, tp_max=576, max_new=50)
TEXT = "hello there world"


def _ref_wav(seed=0, n=8000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def served(pipes, tmp_path_factory):  # noqa: F811
    """Both pipelines greedy (top_k 1), on a 1 s reference at 8 kHz that is
    also on disk for the HTTP tests."""
    jp, pp = pipes
    for p in (jp, pp):
        p.cfg = dataclasses.replace(p.cfg, top_k=1)
        p.set_ref_audio(_ref_wav(), sr=8000)
    path = tmp_path_factory.mktemp("serve") / "ref.wav"
    save_wav(str(path), _ref_wav(), 8000)
    return jp, pp, str(path)


@pytest.fixture(scope="module")
def service(served):
    _, pp, _ = served
    svc = ContinuousTTSService(pp, **POOL)
    yield svc
    svc.close()


def _assert_within_lsb(got, want):
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= LSB


# -- pipeline ----------------------------------------------------------------


def test_aux_references_mean_ge_matches_jax(served, tmp_path):
    """set_ref_audio(aux_wavs=...): ge is the mean over the main and the
    auxiliary references, each at its own length, allclose to the JAX
    package's; a missing path is skipped; requests voice the fused ge."""
    jp, pp, ref = served
    aux = tmp_path / "aux.wav"
    save_wav(str(aux), _ref_wav(5, 6000) * 2.0, 8000)
    aux_wavs = [str(aux), (_ref_wav(6, 7000), 8000), "/missing/skipped.wav"]
    try:
        jr = jp.set_ref_audio(ref, aux_wavs=aux_wavs)
        pr = pp.set_ref_audio(ref, aux_wavs=aux_wavs)
        assert len(pr.aux_specs) == len(pr.aux_sv_embs) == 2
        assert pr.ge.shape == jr.ge.shape == (1, 1, pp.s2.cfg.gin_channels)
        np.testing.assert_allclose(pr.ge, jr.ge, rtol=1e-3, atol=1e-4 * np.abs(jr.ge).max())
        _, wj = jp.run(TEXT, "en", seed=0, max_sec=2)
        _, wp = pp.run(TEXT, "en", seed=0, max_sec=2)
        _assert_within_lsb(wp, wj)
        pp.set_ref_audio(ref)
        _, plain = pp.run(TEXT, "en", seed=0, max_sec=2)
        assert not np.array_equal(plain, wp)  # the fused timbre does change the voice
    finally:
        jp.set_ref_audio(_ref_wav(), sr=8000)
        pp.set_ref_audio(_ref_wav(), sr=8000)


def test_recover_drops_the_reference(served):
    _, pp, _ = served
    try:
        pp.recover()
        assert pp.ref is None
        with pytest.raises(RuntimeError, match="set_ref_audio"):
            pp.run(TEXT, "en")
    finally:
        pp.set_ref_audio(_ref_wav(), sr=8000)


# -- the continuous service -------------------------------------------------


def test_service_matches_run_and_jax_service(served, service):
    """A greedy request through the pool equals `run` sample for sample,
    and the JAX continuous service within 1 LSB."""
    jp, pp, _ = served
    sr_c, audio_c = service.synthesize(TEXT, "en")
    sr_b, audio_b = pp.run(TEXT, "en", seed=0, max_sec=2)
    assert sr_c == sr_b
    np.testing.assert_array_equal(audio_c, audio_b)
    jsvc = JService(jp, **POOL)
    try:
        sr_j, audio_j = jsvc.synthesize(TEXT, "en")
    finally:
        jsvc.close()
    assert sr_j == sr_c
    _assert_within_lsb(audio_c, audio_j)


def test_concurrent_requests_share_the_pool(service):
    texts = ["hello there world", "general kenobi speaks. twice over!", "a third request arrives"]
    jobs = [service.submit(t, "en") for t in texts]
    results = [service.result(j, timeout=120) for j in jobs]
    for (sr, audio), job in zip(results, jobs):
        hop = 2 * int(np.prod(service.pipeline.s2.cfg.upsample_rates))
        silence = int(sr * job.fragment_interval)
        n_tok = [len(job.tokens[r]) for r in job.rids]
        assert audio.dtype == np.int16 and len(audio) == sum(n_tok) * hop + (len(n_tok) - 1) * silence
    assert service.cb.peak_live == 2  # two rows decoded at once in the two-slot pool


def test_one_s2_job_span_per_job(service):
    """Each job gets a process-unique id; its submit is one `serve.submit`
    span and its S2 one `s2.job` span on a finisher thread, with the launch,
    fetch and join inside it, all under the job's id."""
    t_from = time.perf_counter_ns()
    jobs = [service.submit(t, "en") for t in ("one job here", "and a second. with two segments!")]
    for j in jobs:
        service.result(j, timeout=120)
    snap = recorder().snapshot()

    def spans(name):
        sp = snap.spans_named(name)
        return {c: v[sp["t0"] >= t_from] for c, v in sp.items()}

    ids = sorted(j.id for j in jobs)
    assert len(set(ids)) == 2 and sorted(spans("serve.submit")["rid"].tolist()) == ids
    s2 = spans("s2.job")
    assert sorted(s2["rid"].tolist()) == ids
    assert sorted(s2["attr"][:, 0].tolist()) == sorted(len(j.segments) for j in jobs)
    assert threading.get_native_id() not in s2["thread"].tolist()
    for child in ("s2.launch", "s2.fetch", "s2.join"):
        c = spans(child)
        assert sorted(c["rid"].tolist()) == ids and set(c["parent"].tolist()) == set(s2["seq"].tolist())


def test_threads_share_the_pool(service):
    results, errors = {}, []

    def worker(t):
        try:
            results[t] = service.synthesize(t, "en", timeout=120)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    texts = ["first thread speaks", "second thread speaks", "third thread speaks"]
    threads = [threading.Thread(target=worker, args=(t,)) for t in texts]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    assert set(results) == set(texts)
    assert all(a.dtype == np.int16 and len(a) > 0 for _, a in results.values())


def test_seeded_sampling_reproducible(service):
    """Explicit sampling rides the pool; the same seed gives the same audio."""
    kw = dict(top_k=5, temperature=1.0, seed=3, repetition_penalty=1.35)
    _, a1 = service.synthesize(TEXT, "en", **kw)
    _, a2 = service.synthesize(TEXT, "en", **kw)
    np.testing.assert_array_equal(a1, a2)


def test_requires_reference(served, service):
    _, pp, _ = served
    ref = pp.ref
    try:
        pp.ref = None
        with pytest.raises(RuntimeError, match="set_ref_audio"):
            service.synthesize("hi there", "en")
    finally:
        pp.ref = ref


def test_v3_pipeline_refused():
    with pytest.raises(ValueError, match="v3/v4"):
        ContinuousTTSService(types.SimpleNamespace(v3=object()))


def test_weight_swap_quiesces_pool(service):
    old = service.cb
    with service.paused_for_weight_swap():
        pass  # a loader would swap pipeline.s1 here
    assert service.cb is not old
    _, audio = service.synthesize("hello again world", "en")
    assert len(audio) > 0


def test_swap_warms_the_new_pool_before_the_scheduler_steps_it(service, monkeypatch):
    """A weight swap warms the new batcher up in the swapping thread before
    the scheduler thread can see it: no two threads ever step one pool.
    Each step of the swap is slowed so that the scheduler's 0.5 s wake-up
    falls inside the warm-up."""
    busy, overlaps = set(), []
    real_step = ContinuousBatcher.step

    def step(self, n=25):
        if id(self) in busy:
            overlaps.append(threading.current_thread().name)
        busy.add(id(self))
        try:
            time.sleep(0.6 if service._draining else 0.0)
            return real_step(self, n)
        finally:
            busy.discard(id(self))

    monkeypatch.setattr(ContinuousBatcher, "step", step)
    with service.paused_for_weight_swap():
        pass
    assert not overlaps, overlaps
    _, audio = service.synthesize("hello again world", "en")
    assert len(audio) > 0 and not overlaps


# -- the HTTP API ------------------------------------------------------------


@pytest.fixture(scope="module")
def server(served):
    _, pp, ref = served
    swaps = []
    svc = TTSService(pp, weight_loader=lambda which, path: swaps.append((which, path)))
    srv = serve(svc, port=0)
    host, port = srv.server_address
    yield f"http://{host}:{port}", ref, swaps
    srv.shutdown()
    srv.server_close()


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def test_health(server):
    base, _, _ = server
    code, body, _ = _get(base + "/health")
    assert code == 200 and json.loads(body)["status"] == "ok"


def test_tts_get_wav(server):
    base, ref, _ = server
    q = urllib.parse.urlencode({"text": "Hello there world", "text_lang": "en", "ref_audio_path": ref, "seed": 3,
                                "max_sec": 2})
    code, body, ctype = _get(base + "/tts?" + q)
    assert code == 200, body
    assert ctype == "audio/wav" and body[:4] == b"RIFF" and len(body) > 1000
    assert struct.unpack("<I", body[40:44])[0] == len(body) - 44


def test_tts_wav_bytes_match_jax(served, server):
    """The same greedy request through the port's TTSService and the JAX
    package's: the same header, PCM within 1 LSB."""
    jp, pp, ref = served
    req = {"text": "Short test", "text_lang": "en", "ref_audio_path": ref, "seed": 1, "top_k": 1}
    code_p, body_p, _ = TTSService(pp).tts(dict(req))
    code_j, body_j, _ = JTTSService(jp).tts(dict(req))
    assert code_p == code_j == 200
    assert body_p[:44] == body_j[:44]
    _assert_within_lsb(np.frombuffer(body_p[44:], "<i2"), np.frombuffer(body_j[44:], "<i2"))


def test_tts_post_json_raw(server):
    base, ref, _ = server
    code, body, ctype = _post(base + "/tts", {"text": "Short test", "text_lang": "en", "ref_audio_path": ref,
                                              "media_type": "raw", "seed": 1})
    assert code == 200 and ctype == "audio/raw" and len(body) > 500


def test_tts_validation_errors(server):
    base, ref, _ = server
    code, body, _ = _get(base + "/tts?text=hi&text_lang=en")
    assert code == 400 and b"ref_audio_path" in body
    q = urllib.parse.urlencode({"text": "hi", "text_lang": "xx", "ref_audio_path": ref})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 400 and b"not supported" in body
    q = urllib.parse.urlencode({"text": "hi there", "text_lang": "en", "ref_audio_path": ref,
                                "text_split_method": "cut99"})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 400 and b"cut99" in body


def test_tts_zh_is_200_unknown_language_is_400(server):
    """text_lang=zh (and auto) answer 200 with audio on the batch and the
    streaming route; a text_lang outside LANGS answers 400 from that check."""
    base, ref, _ = server
    q = urllib.parse.urlencode({"text": "我在用iPhone工作", "text_lang": "zh", "ref_audio_path": ref, "seed": 3,
                                "max_sec": 2})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 200 and body[:4] == b"RIFF" and struct.unpack("<I", body[40:44])[0] == len(body) - 44 > 0
    code, body, _ = _get(base + "/tts?" + q + "&streaming_mode=true")
    assert code == 200 and body[:4] == b"RIFF" and len(body) > 44
    q = urllib.parse.urlencode({"text": "你好。こんにちは。", "text_lang": "auto", "ref_audio_path": ref, "max_sec": 2})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 200 and body[:4] == b"RIFF"
    q = urllib.parse.urlencode({"text": "我在用iPhone工作", "text_lang": "tlh", "ref_audio_path": ref})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 400 and b"text_lang: tlh is not supported" in body


def test_set_weights_endpoint(server):
    base, _, swaps = server
    code, body, _ = _get(base + "/set_gpt_weights?weights_path=/tmp/x.npz")
    assert code == 200 and json.loads(body)["message"] == "success"
    assert swaps[-1] == ("gpt", "/tmp/x.npz")


def test_wav_bytes_header():
    b = wav_bytes(np.zeros(100, np.int16), 32000)
    assert b[:4] == b"RIFF" and b[8:12] == b"WAVE"
    assert len(b) == 44 + 200


def test_tts_streaming_mode(server):
    base, ref, _ = server
    q = urllib.parse.urlencode({"text": "First sentence. Second one!", "text_lang": "en", "ref_audio_path": ref,
                                "seed": 4, "streaming_mode": "true"})
    with urllib.request.urlopen(base + "/tts?" + q) as r:
        assert r.status == 200
        data = r.read()
    assert data[:4] == b"RIFF"
    assert struct.unpack("<I", data[40:44])[0] == 0  # streaming header: zero length, PCM follows
    assert len(data) > 44 + 1000


def test_legacy_api_contract(server):
    """Legacy api.py endpoints: /change_refer and GET '/' with query params."""
    base, ref, _ = server
    code, _, _ = _get(base + "/?" + urllib.parse.urlencode({"text": "hi there", "text_language": "en"}))
    assert code == 400  # no default reference and none given
    q = urllib.parse.urlencode({"refer_wav_path": ref, "prompt_text": "hello ref", "prompt_language": "en"})
    code, body, _ = _get(base + "/change_refer?" + q)
    assert code == 200 and json.loads(body)["code"] == 0
    q = urllib.parse.urlencode({"text": "hello there. nice day.", "text_language": "en", "cut_punc": ".", "top_k": 5})
    code, body, _ = _get(base + "/?" + q)
    assert code == 200 and body[:4] == b"RIFF"
    q = urllib.parse.urlencode({"text": "good morning", "text_language": "英文"})  # display-name language
    code, body, _ = _get(base + "/?" + q)
    assert code == 200 and body[:4] == b"RIFF"


def test_set_refer_audio_endpoint(server):
    base, ref, _ = server
    code, body, _ = _get(base + "/set_refer_audio?" + urllib.parse.urlencode({"refer_audio_path": ref}))
    assert code == 200 and json.loads(body)["message"] == "success"
    code, body, _ = _get(base + "/set_refer_audio?refer_audio_path=/nonexistent.wav")
    assert code == 400 and b"Exception" in body


def test_tts_with_aux_ref_audio_paths(server, tmp_path):
    """aux_ref_audio_paths, JSON list or comma-separated; missing paths are
    skipped as the reference does (TTS.py:1106)."""
    aux = tmp_path / "aux.wav"
    save_wav(str(aux), _ref_wav(5, 6000) * 2.0, 8000)
    base, ref, _ = server
    code, body, _ = _post(base + "/tts", {"text": "Aux fusion test", "text_lang": "en", "ref_audio_path": ref,
                                          "aux_ref_audio_paths": [str(aux), "/missing/skipped.wav"], "seed": 2})
    assert code == 200 and body[:4] == b"RIFF"
    q = urllib.parse.urlencode({"text": "Aux fusion get", "text_lang": "en", "ref_audio_path": ref,
                                "aux_ref_audio_paths": str(aux), "seed": 2})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 200 and body[:4] == b"RIFF"


def test_tts_media_type_ogg_aac(server, monkeypatch):
    """ogg/aac: 400 naming the missing encoder, 400 for an unknown format,
    and the packer's bytes when an encoder is there (a stub here)."""
    base, ref, _ = server
    monkeypatch.setattr("shutil.which", lambda name: None)  # no ffmpeg, whatever the machine has
    q = urllib.parse.urlencode({"text": "Hi", "text_lang": "en", "ref_audio_path": ref, "media_type": "aac",
                                "seed": 1})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 400 and b"ffmpeg" in body
    q = urllib.parse.urlencode({"text": "Hi", "text_lang": "en", "ref_audio_path": ref, "media_type": "mp9"})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 400 and b"not supported" in body
    monkeypatch.setitem(api_mod._PACKERS, "ogg", lambda a, sr: b"OggS" + a.tobytes()[:64])
    q = urllib.parse.urlencode({"text": "Hi", "text_lang": "en", "ref_audio_path": ref, "media_type": "ogg",
                                "seed": 1})
    code, body, ctype = _get(base + "/tts?" + q)
    assert code == 200 and ctype == "audio/ogg" and body[:4] == b"OggS"


def test_speaker_registry(server):
    """The legacy api.py speaker list: named weight sets with a default
    reference each, chosen by the `spk` request param."""
    base, ref, _ = server
    code, body, _ = _get(base + "/speakers")
    assert code == 200 and json.loads(body)["speakers"] == {}
    code, body, _ = _post(base + "/speakers", {"gpt_weights": "/tmp/x.npz"})
    assert code == 400 and b"name" in body
    code, body, _ = _post(base + "/speakers", {"name": "alice", "gpt_weights": "/nonexistent/w.npz"})
    assert code == 400 and b"not found" in body
    code, body, _ = _post(base + "/speakers", {"name": "alice", "refer_wav_path": ref, "prompt_text": "hi",
                                               "prompt_language": "en"})
    assert code == 200, body
    q = urllib.parse.urlencode({"text": "hello", "text_lang": "en", "ref_audio_path": ref, "spk": "bob"})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 400 and b"unknown speaker" in body
    q = urllib.parse.urlencode({"text": "hello there", "text_lang": "en", "spk": "alice", "seed": 5})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 200 and body[:4] == b"RIFF", body
    code, body, _ = _get(base + "/speakers")
    assert json.loads(body)["current"] == "alice"


def test_speaker_weight_swap(server, tmp_path):
    base, ref, swaps = server
    w = tmp_path / "bob_s1.npz"
    w.write_bytes(b"x")
    code, body, _ = _post(base + "/speakers", {"name": "bob", "gpt_weights": str(w), "refer_wav_path": ref,
                                               "prompt_text": "hi", "prompt_language": "en"})
    assert code == 200, body
    n_swaps = len(swaps)
    q = urllib.parse.urlencode({"text": "switch voices now", "text_lang": "en", "spk": "bob", "seed": 2})
    code, body, _ = _get(base + "/tts?" + q)
    assert code == 200, body
    assert ("gpt", str(w)) in swaps[n_swaps:]
    n_swaps = len(swaps)
    code, body, _ = _get(base + "/tts?" + q)  # the same speaker again: no second swap
    assert code == 200 and len(swaps) == n_swaps


def test_gui_client_core(server, tmp_path):
    """The desktop client's REST core against the live server: health,
    weight swap, synthesis to a file, and the server's message on failure."""
    from gpt_sovits_tpu_torch.serve.gui_client import TTSClient, synthesize_to_file

    base, ref, swaps = server
    c = TTSClient(base)
    assert c.health()
    ok, _ = c.set_gpt_weights("/tmp/some_weights.ckpt")
    assert ok and swaps[-1] == ("gpt", "/tmp/some_weights.ckpt")
    out = synthesize_to_file(c, str(tmp_path / "gui_out.wav"), text="hello from the desktop client",
                             text_lang="en", ref_audio_path=ref, seed=3, max_sec=2)
    with open(out, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and len(data) > 1000
    with pytest.raises(RuntimeError):
        synthesize_to_file(c, str(tmp_path / "x.wav"), text="", text_lang="en", ref_audio_path=ref)
    assert not TTSClient("http://127.0.0.1:9").health()


def test_http_continuous_mode(served, service):
    """api_v2 /tts over a real socket in continuous mode: requests ride the
    pool and equal the batch path's audio; zh rides the pool too; an
    explicit serial decode takes run()."""
    _, pp, ref = served
    srv = serve(TTSService(pp, continuous=service), port=0)
    host, port = srv.server_address
    base = f"http://{host}:{port}"
    try:
        steps = service.cb.steps_run
        code, body, _ = _post(base + "/tts", {"text": TEXT, "text_lang": "en", "ref_audio_path": ref})
        assert code == 200 and body[:4] == b"RIFF" and service.cb.steps_run > steps
        _, want = pp.run(TEXT, "en", seed=0, max_sec=2)
        np.testing.assert_array_equal(np.frombuffer(body[44:], "<i2"), want)
        steps = service.cb.steps_run
        code, body, _ = _post(base + "/tts", {"text": "我在用iPhone工作", "text_lang": "zh", "ref_audio_path": ref})
        assert code == 200 and body[:4] == b"RIFF" and service.cb.steps_run > steps
        steps = service.cb.steps_run
        code, body, _ = _post(base + "/tts", {"text": TEXT, "text_lang": "en", "ref_audio_path": ref,
                                              "parallel_infer": False, "seed": 1})
        assert code == 200 and body[:4] == b"RIFF" and service.cb.steps_run == steps
    finally:
        srv.shutdown()
        srv.server_close()


def test_pool_prefill_carries_zh_bert(served, service):
    """A zh request's BERT features reach S1's bert_proj through the pool's
    prefill: some call sees exactly the segment's non-zero rows."""
    _, pp, _ = served
    text = "银行行长说你好。"
    (seg,) = pp.preprocess(text, "zh", pp.cfg.text_split_method)
    assert np.abs(seg["bert"]).sum(-1).all()
    seen = []
    hook = pp.s1.bert_proj.register_forward_hook(lambda mod, args, out: seen.append(args[0].detach().clone()))
    try:
        sr, audio = service.synthesize(text, "zh", timeout=300)
    finally:
        hook.remove()
    assert audio.dtype == np.int16 and audio.size > 0
    want = torch.from_numpy(seg["bert"])
    n = want.shape[0]
    assert any(x.shape[-2] >= n and any(torch.equal(row[-n:], want) for row in x.reshape(-1, *x.shape[-2:]))
               for x in seen), [tuple(x.shape) for x in seen]
