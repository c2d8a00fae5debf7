"""Continuous-batching serving mode (port of
gpt_sovits_tpu/serve/continuous_service.py).

Couples the pipeline to `infer/continuous.ContinuousBatcher`: the S1 decode
of every request in flight shares one slot pool (requests join at segment
boundaries instead of waiting out a batch), and S2 runs per finished
request on a finisher thread pool, so that the S1 scheduler never waits for
the vocoder. Sampling options, seed and cut method are per request; each
request carries the RefCache snapshot it was submitted with, so concurrent
requests with different references cannot voice each other's; and a weight
swap quiesces the pool (`paused_for_weight_swap`), so that the pool never
decodes with old S1 weights while S2 uses new ones.

Threads: one scheduler thread steps the pool (a batcher is warmed up
before that thread sees it, so no two threads ever step one pool), two
finisher threads run S2.

Each job has a process-unique `id`. The recorder (`utils/metrics.py`)
takes a `serve.submit` span a `submit` (the text frontend and the enqueue,
on the caller's thread) and an `s2.job` span a job on its finisher thread
(attribute: segments), with children `s2.launch`, `s2.fetch` and
`s2.join`; the pool's own records are the batcher's (infer/continuous.py).
Every device call happens under `torch.no_grad`, which each thread enters
itself (the batcher's `step` and `_finish` here are decorated with it).
"""

from __future__ import annotations

import contextlib
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from gpt_sovits_tpu_torch.infer.continuous import ContinuousBatcher
from gpt_sovits_tpu_torch.infer.pipeline import _next_bucket, snap_speed
from gpt_sovits_tpu_torch.models.t2s import GenResult
from gpt_sovits_tpu_torch.utils.metrics import next_request_id, recorder

_REC = recorder()
_SUBMIT, _S2_JOB = _REC.intern("serve.submit"), _REC.intern("s2.job")


@dataclass(eq=False)  # identity semantics: jobs are deduplicated with set()
class Job:
    """One request: its text segments, mapped to batcher rids in order."""

    rids: list
    segments: list
    ref: object  # the RefCache snapshot at submit time
    speed: float
    fragment_interval: float
    id: int = -1  # process-unique (utils/metrics.py next_request_id)
    done: threading.Event = field(default_factory=threading.Event)
    tokens: dict = field(default_factory=dict)  # rid -> np token array
    audio: Optional[np.ndarray] = None
    error: Optional[Exception] = None


class ContinuousTTSService:
    """Single-controller serving loop over the slot pool."""

    def __init__(
        self,
        pipeline,
        *,
        slots: int = 8,
        segment: int = 25,
        tx_max: int = 512,
        tp_max: int = 512,
        max_new: int = 750,
        weight_quant: Optional[str] = None,
        kv_quant: Optional[str] = None,
        use_fused: Optional[bool] = None,
    ):
        if pipeline.v3 is not None:
            raise ValueError("continuous mode serves the v1/v2 S2 decode path (v3/v4 use the batch pipeline)")
        self.pipeline = pipeline
        self.segment = segment
        weight_quant = weight_quant or pipeline.s1_weight_quant
        self._cb_kw = dict(
            slots=slots, tx_max=tx_max, tp_max=tp_max, max_new=max_new, weight_quant=weight_quant,
            kv_quant=kv_quant or pipeline.s1_kv_quant,
            use_fused=pipeline.use_fused_s1 if use_fused is None else use_fused,
        )
        self._same_weights = weight_quant == pipeline.s1_weight_quant
        self.cb = self._build_batcher()
        # the first requests then pay no first-use cost (kernel build,
        # allocator growth) inside the serving path
        self.cb.warmup(self.segment)
        self._jobs: dict[int, Job] = {}  # rid -> job
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._inflight = 0  # jobs submitted and not yet collected
        self._draining = False  # a weight swap is in progress: new submissions wait
        self._running = True
        # S2 off the scheduler thread: two workers, so that one job's fetch
        # overlaps the next job's S2
        self._finisher = ThreadPoolExecutor(max_workers=2, thread_name_prefix="s2-finish")
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _build_batcher(self) -> ContinuousBatcher:
        p = self.pipeline
        cfg = p.cfg
        return ContinuousBatcher(
            p.s1, top_k=cfg.top_k, top_p=cfg.top_p, temperature=cfg.temperature,
            repetition_penalty=cfg.repetition_penalty, device=p.device,
            fused_weights=p._s1_weights if self._same_weights else None, **self._cb_kw,
        )

    # -- request side -------------------------------------------------------

    def submit(
        self,
        text: str,
        language: str = "auto",
        *,
        speed: float = 1.0,
        ref=None,
        text_split_method: Optional[str] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
        seed: Optional[int] = None,
        fragment_interval: Optional[float] = None,
    ) -> Job:
        """Queue a request's segments on the pool and return its job (see
        `synthesize`; `result` waits for it)."""
        job_id = next_request_id()
        seq = _REC.begin(_SUBMIT, job_id)
        try:
            p = self.pipeline
            ref = ref if ref is not None else p.ref
            if ref is None:
                raise RuntimeError("call pipeline.set_ref_audio first")
            segments = p.preprocess(text, language, text_split_method or p.cfg.text_split_method)
            if not segments:
                raise ValueError("no synthesizable text")
            prompt = np.asarray(ref.prompt_semantic, np.int64)
            job = Job(rids=[], segments=segments, ref=ref, speed=speed,
                      fragment_interval=p.cfg.fragment_interval if fragment_interval is None else fragment_interval,
                      id=job_id)
            with self._wake:
                while self._draining and self._running:
                    self._wake.wait(timeout=0.5)
                if not self._running:
                    raise RuntimeError("service closed")
                for i, seg in enumerate(segments):
                    rid = self.cb.submit(
                        np.asarray(seg["phones"], np.int64), np.asarray(seg["bert"], np.float32), prompt,
                        # segment i of a seeded request has a stream of its own
                        seed=None if seed is None else seed * 1009 + i,
                        top_k=top_k, top_p=top_p, temperature=temperature, repetition_penalty=repetition_penalty,
                    )
                    job.rids.append(rid)
                    self._jobs[rid] = job
                self._inflight += 1
                self._wake.notify()
            return job
        finally:
            _REC.end(seq)

    def result(self, job: Job, timeout: float = 600.0) -> tuple[int, np.ndarray]:
        """Wait for a job -> (sample rate, int16 audio)."""
        try:
            if not job.done.wait(timeout):
                raise TimeoutError("synthesis timed out")
        finally:
            with self._wake:
                self._inflight -= 1
                self._wake.notify_all()
        if job.error is not None:
            raise job.error
        return self.pipeline.mel_cfg.sampling_rate, (np.clip(job.audio, -1.0, 1.0) * 32767.0).astype(np.int16)

    def synthesize(self, text: str, language: str = "auto", *, timeout: float = 600.0, **kw) -> tuple[int, np.ndarray]:
        """Blocking synthesis; the S1 decode shares the pool with concurrent
        callers. `ref` is the RefCache snapshot to voice this request with
        (default: the pipeline's current one; pass the snapshot taken under
        the API's lock to avoid reference races). Other keywords as
        `submit`. Returns (sr, int16 audio)."""
        return self.result(self.submit(text, language, **kw), timeout)

    @contextlib.contextmanager
    def paused_for_weight_swap(self):
        """Quiesce the pool around a weight swap: block new submissions,
        wait out the jobs in flight (they finish on the old weights), yield
        for the swap, then rebuild the batcher from the pipeline's S1. The
        new batcher is warmed up before the scheduler thread sees it, so
        that no two threads step one pool."""
        with self._wake:
            self._draining = True
            while self._inflight > 0:
                self._wake.wait(timeout=0.5)
        try:
            yield
        finally:
            cb = self._build_batcher()
            cb.warmup(self.segment)
            self.cb = cb
            with self._wake:
                self._draining = False
                self._wake.notify_all()

    def close(self):
        with self._wake:
            self._running = False
            self._wake.notify_all()
        self._worker.join(timeout=10)
        self._finisher.shutdown(wait=True)

    # -- worker side --------------------------------------------------------

    def _loop(self):
        while True:
            with self._wake:
                while self._running and not self.cb.pending:
                    self._wake.wait(timeout=0.5)
                if not self._running:
                    return
            try:
                finished = self.cb.step(self.segment)
            except Exception as e:  # the scheduler keeps running: report to every waiter
                traceback.print_exc()
                with self._lock:
                    for job in set(self._jobs.values()):
                        job.error = e
                        job.done.set()
                    self._jobs.clear()
                continue
            for rid, toks in finished.items():
                with self._lock:
                    job = self._jobs.pop(rid, None)
                if job is None:
                    continue
                job.tokens[rid] = toks
                if len(job.tokens) == len(job.rids):
                    self._finisher.submit(self._finish_job, job)

    def _finish_job(self, job: Job) -> None:
        seq = _REC.begin(_S2_JOB, job.id)
        try:
            job.audio = self._finish(job)
        except Exception as e:  # reported to the request's caller
            job.error = e
        finally:
            _REC.end(seq, len(job.segments))
        job.done.set()

    @torch.no_grad()
    def _finish(self, job: Job) -> np.ndarray:
        """S2 on every segment of a finished job in one batched call, the
        voice of the job's reference (`_s2_launch`), segments joined by the
        inter-fragment silence."""
        p = self.pipeline
        segs = job.segments
        with _REC.span("s2.launch", job.id):
            toks = [job.tokens[r] for r in job.rids]
            lengths = [len(t) for t in toks]
            codes = np.zeros((len(segs), self.cb.max_new), np.int64)
            for i, t in enumerate(toks):
                codes[i, : len(t)] = t
            dev = p.device
            s1 = (GenResult(torch.from_numpy(codes).to(dev), torch.tensor(lengths, device=dev), 0),
                  _next_bucket(max(len(s["phones"]) for s in segs)))
            state = p._s2_launch(segs, s1, max(lengths), speed=snap_speed(job.speed), ref=job.ref)
        with _REC.span("s2.fetch", job.id):
            wavs = p._s2_fetch(state)
        with _REC.span("s2.join", job.id):
            silence = np.zeros(int(p.mel_cfg.sampling_rate * job.fragment_interval), np.float32)
            pieces = []
            for w in wavs:
                pieces += [w, silence]
            return np.concatenate(pieces[:-1])
