"""The port's native batch reader (gpt_sovits_tpu_torch/native.py over
csrc/gsvt_io.cc) mirrors tests/test_native_io.py: parity with the Python
readers, the same errors, and a dataset's batch equal whichever path read
it. The library is built with g++ at first use; without a compiler the
tests that need it skip (decided in the fixture)."""

import struct

import numpy as np
import pytest

import chip_smoke
from gpt_sovits_tpu_torch import native
from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav
from gpt_sovits_tpu_torch.train import data as pdata


@pytest.fixture
def lib():
    if native.load() is None:
        pytest.skip("native library not built (no C++ compiler)")
    return native


def test_wav_batch_matches_python(lib, tmp_path):
    rng = np.random.default_rng(0)
    paths, refs = [], []
    for i, n in enumerate([1000, 2500, 777]):
        x = (rng.standard_normal(n) * 0.3).astype(np.float32)
        p = str(tmp_path / f"a{i}.wav")
        save_wav(p, x, 16000 + i)
        paths.append(p)
        refs.append(load_wav(p)[0])
    out, lengths, srs, status = lib.wav_batch(paths, max(len(r) for r in refs))
    assert (status == 0).all() and list(srs) == [16000, 16001, 16002]
    for i, r in enumerate(refs):
        assert lengths[i] == len(r)
        np.testing.assert_allclose(out[i, : len(r)], r, atol=1e-6)
        assert (out[i, len(r):] == 0).all()


def _stereo_wav(path, x, sr):
    """16-bit PCM with two interleaved channels, written here apart from the port's save_wav."""
    pcm = np.clip(np.round(x.reshape(-1) * 32768.0), -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
                + struct.pack("<IHHIIHH", 16, 1, 2, sr, sr * 4, 4, 16) + b"data" + struct.pack("<I", len(pcm)) + pcm)


def test_wav_batch_stereo_downmix(lib, tmp_path):
    st = (np.random.default_rng(1).standard_normal((800, 2)) * 0.3).astype(np.float32)
    p = str(tmp_path / "st.wav")
    _stereo_wav(p, st, 32000)
    want = load_wav(p)[0]  # the Python reader's mono downmix
    assert len(want) == 800
    out, lengths, srs, status = lib.wav_batch([p], 1024)
    assert status[0] == 0 and lengths[0] == len(want)
    np.testing.assert_allclose(out[0, : len(want)], want, atol=1e-6)


def test_wav_batch_missing_file(lib, tmp_path):
    out, lengths, srs, status = lib.wav_batch([str(tmp_path / "nope.wav")], 64)
    assert status[0] != 0 and lengths[0] == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_npy_batch(lib, tmp_path, dtype):
    rng = np.random.default_rng(2)
    paths, refs = [], []
    for i, rows in enumerate([50, 81]):
        a = rng.standard_normal((rows, 24)).astype(dtype)
        p = str(tmp_path / f"f{i}.npy")
        np.save(p, a)
        paths.append(p)
        refs.append(a.astype(np.float32))
    out, rows, status = lib.npy_batch(paths, 100, 24)
    assert (status == 0).all()
    for i, r in enumerate(refs):
        assert rows[i] == r.shape[0]
        np.testing.assert_allclose(out[i, : r.shape[0]], r, atol=1e-6)


def test_npy_batch_wrong_cols(lib, tmp_path):
    p = str(tmp_path / "bad.npy")
    np.save(p, np.zeros((5, 7), np.float32))
    out, rows, status = lib.npy_batch([p], 10, 24)
    assert status[0] != 0 and rows[0] == 0


def test_built_into_the_ignored_build_directory(lib):
    so = native._target()
    assert so.exists() and so.parent == native.BUILD_DIR and so.parent.parts[-2:] == ("build", "native")
    assert "build/" in (native.BUILD_DIR.parents[1] / ".gitignore").read_text().split()


@pytest.mark.parametrize("cls", [pdata.S2Dataset, pdata.V3Dataset])
def test_dataset_batch_equal_on_either_path(lib, tmp_path, monkeypatch, cls):
    chip_smoke.write_corpus(tmp_path, (1.4, 1.5), seed=4, ssl_dim=8, sv=False)
    ds = cls(str(tmp_path))
    fast = ds.collate([0, 1])
    monkeypatch.setattr(pdata.native, "load", lambda: None)
    slow = ds.collate([0, 1])
    assert ds.reads == {"native": 1, "python": 1}
    assert fast.keys() == slow.keys()
    for k in fast:
        np.testing.assert_array_equal(fast[k], slow[k], err_msg=k)


def test_data_iterator_prefetch_equivalent_and_propagates_errors():
    class FakeDS:
        def collate(self, idxs):
            return {"idxs": list(idxs)}

    class BadDS:
        def collate(self, idxs):
            raise RuntimeError("boom")

    class FakeSampler:
        def epoch_batches(self, epoch):
            return [np.array([i, i + 1]) for i in range(5)]

    plain = [b["idxs"] for b in pdata.data_iterator(FakeDS(), FakeSampler(), 0, prefetch=0)]
    assert plain == [b["idxs"] for b in pdata.data_iterator(FakeDS(), FakeSampler(), 0, prefetch=2)]
    with pytest.raises(RuntimeError, match="boom"):
        list(pdata.data_iterator(BadDS(), FakeSampler(), 0, prefetch=2))
