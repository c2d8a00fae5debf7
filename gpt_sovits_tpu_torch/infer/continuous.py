"""Continuous batching for the S1 decode (port of
gpt_sovits_tpu/infer/continuous.py).

`generate` (models/t2s.py) decodes one fixed batch to the end: a request
that arrives meanwhile waits for the whole batch. Here a fixed pool of B
cache slots decodes in short segments of steps, and between segments the
host scheduler evicts finished rows and admits queued requests into free
slots with one batched prefill. Each row writes its new K/V at its own slot
(rows joined at different times are at different steps), through the
fused S1 step (K1, ops/decode_step.py) on a card or the plain
`T2SDecoder.decode_step`.

  * Sampling parameters are per row, (B,) tensors, so one pool serves any
    mix of top_k / top_p / temperature / repetition penalty; each row
    samples from the full vocabulary in the reference's order (penalty ->
    top-p -> temperature -> top-k), as `models/t2s.py filter_logits` does
    with that row's scalars.
  * A row's random draws depend only on its request's seed and its step:
    each slot holds its request's own numpy Philox stream on the host, and
    a segment draws one uniform a step for every installed row (n x B
    float32 on the host, one copy to the device a segment); the device
    turns the uniform into a token by inverting the row's CDF
    (`sample_token_rows`: a softmax, a cumsum and a searchsorted over
    (B, V) a step, beside the filter's two sorts). Greedy rows (top_k 1)
    take the argmax.
  * The scheduler runs ahead of the host: after each segment the rows'
    done flags and lengths are copied to pinned host memory without
    blocking, each copy with a CUDA event, and are read on a later pass
    once the event has completed (up to `lookahead` copies in flight).
    Eviction lags by up to that many segments, which only delays slot
    reuse: done rows decode masked.
  * No device value is read back to size a step: the host keeps a mirror
    of each slot's step count, from which it passes K1 the rows' write
    slots as a host list.
  * A step is K1's launch and a tail (`ContinuousBatcher._tail`: the mask
    write, the head, the sampler, the state updates: some 70 small
    kernels). On a card in fused mode the tail runs as one CUDA graph
    replay (`_TailGraph`, captured at the pool's first step, which `warmup`
    runs), launched with the interpreter lock held, so the host issues two
    launches a step; elsewhere it runs eagerly, the same function. The tail
    reads only tensors at fixed addresses: the slot state, K1's output
    buffer, and a segment's write slots and uniforms staged on the device
    (one copy each a segment), of which it takes the row of a device step
    index that it advances itself.
  * The recorder (`utils/metrics.py`) takes, on the scheduler's thread: a
    `pool.pass` span a `step()` (attributes: steps, the thread's CPU time
    outside the copy waits, the wall time blocked on copies, installed
    rows), with `pool.admit` (rows; children `pool.prefill`, `pool.draw`,
    `pool.install`), one `pool.queue` span a row admitted (its enqueue in
    `submit` to its admission), `pool.segment` (steps, rows) and the copy
    waits inside it: `pool.sync_flags` / `pool.sync_tokens` (the wait on
    a device-to-host copy's event) and, on a card, `pool.sync_upload` (an
    admission's plain host-to-device copy, which waits for the stream to
    drain first), each with its CPU time as attribute; a `pool.evict`
    mark a finished row (its length); the counter
    `pool.decoded_row_steps`, stamped at each flag copy's capture: the
    installed rows' growth in length since the copy before, as the copy
    reads it; and the counter `pool.graph_steps`, stamped inside each
    `pool.segment` span: its steps whose tail was a graph replay.

Slot cache layout (per row, T_total = tx_max + tp_max + 1 + max_new rounded
up to 512):
  [0, tx_max)                left-padded phoneme prefix
  [tx_max, tx_max+tp_max)    right-padded semantic prompt
  scratch = tx_max+tp_max    re-fed last prompt token (first-logits trick,
                             overwritten by generated token 0)
  scratch + i                generated token i
Attention only sees the slots a row's mask marks, so the gaps of the fixed
layout do not enter the math. The cache is one K||V tensor (L, B, T_total,
2D) in every mode: bf16, or int8 with (L, B, 2, T_total) scales, as
`generate` keeps it for K1; f32 for the plain step, which reads and writes
its K and V halves through views.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.models.t2s import EOS_MASK_WARMUP_STEPS, T2SDecoder, build_prefix_attn_bias
from gpt_sovits_tpu_torch.ops import decode_step as ds
from gpt_sovits_tpu_torch.utils.metrics import recorder

_REC = recorder()
_PASS, _ADMIT, _PREFILL, _DRAW, _INSTALL, _QUEUE, _SEGMENT, _SYNC_FLAGS, _SYNC_TOKENS, _SYNC_UPLOAD, _EVICT = (
    _REC.intern(n) for n in ("pool.pass", "pool.admit", "pool.prefill", "pool.draw", "pool.install", "pool.queue",
                             "pool.segment", "pool.sync_flags", "pool.sync_tokens", "pool.sync_upload",
                             "pool.evict"))
_DECODED_ROW_STEPS, _GRAPH_STEPS = _REC.intern("pool.decoded_row_steps"), _REC.intern("pool.graph_steps")


def filter_logits_rows(logits, presence, top_k, top_p, temperature, rep_penalty):
    """`models/t2s.py filter_logits` with one set of parameters a row:
    top_k (B,) int (<= 0: off), top_p, temperature, rep_penalty (B,) f32.
    Row i equals filter_logits on row i with row i's scalars: a penalty of
    1 and a temperature of 1 change no value, and top-p applies only where
    top_p < 1, as there. Returns logits/temperature with every token
    outside the row's support at -inf."""
    logits = logits.float()
    rp = rep_penalty[:, None]
    penalized = torch.where(logits < 0, logits * rp, logits / rp)
    logits = torch.where(presence, penalized, logits)
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = (cum > top_p[:, None]) & (top_p < 1.0)[:, None]
    remove_sorted[:, 0] = False
    remove = torch.zeros_like(remove_sorted).scatter(1, sorted_idx, remove_sorted)
    logits = logits.masked_fill(remove, float("-inf"))
    logits = logits / torch.clamp_min(temperature, 1e-5)[:, None]
    # the top_k-th largest value, as torch.topk gives it in filter_logits
    vals = torch.sort(logits, dim=-1, descending=True).values
    kth = vals.gather(1, (torch.clamp(top_k, 1, logits.shape[-1]) - 1)[:, None])
    return logits.masked_fill((top_k > 0)[:, None] & (logits < kth), float("-inf"))


def sample_token_rows(logits, presence, top_k, top_p, temperature, rep_penalty, uniform):
    """One token a row from the filtered distribution (filter_logits_rows):
    the argmax where top_k is 1 (no draw, as `sample_token`), else the
    token whose CDF interval holds the row's uniform (B,) in [0, 1). Each
    row depends only on its own logits and uniform."""
    filtered = filter_logits_rows(logits, presence, top_k, top_p, temperature, rep_penalty)
    cdf = torch.cumsum(torch.softmax(filtered, dim=-1), dim=-1)
    total = cdf[:, -1:]
    # strictly below the total, so the search never passes the last token
    # of positive probability
    x = torch.minimum(uniform[:, None] * total, torch.nextafter(total, torch.zeros_like(total)))
    drawn = torch.searchsorted(cdf, x, right=True)[:, 0].clamp_max(logits.shape[-1] - 1)
    return torch.where(top_k == 1, filtered.argmax(-1), drawn)


@dataclasses.dataclass
class _SlotState:
    """Device state of the pool; the leading dimension of each row tensor
    is B = slots."""

    kv: torch.Tensor  # K||V (L, B, T, 2D): fused bf16 | int8; plain f32
    kv_scales: Optional[torch.Tensor]  # int8 KV: (L, B, 2, T) f32; else None
    mask: torch.Tensor  # (B, T) f32, 1 = attendable
    presence: torch.Tensor  # (B, V) sampled or prompt ids (repetition penalty)
    tok_emb: torch.Tensor  # (B, 1, D) embedding of the last sampled token
    tokens: torch.Tensor  # (B, max_new) generated ids
    gen_count: torch.Tensor  # (B,) tokens sampled so far (>= 1 once admitted)
    lengths: torch.Tensor  # (B,) valid semantic tokens (before EOS)
    prompt_lens: torch.Tensor  # (B,)
    active: torch.Tensor  # (B,) the slot holds a request
    done: torch.Tensor  # (B,) the row finished (EOS or cap)
    top_k: torch.Tensor  # (B,) int64 (<= 0: off)
    top_p: torch.Tensor  # (B,) f32
    temperature: torch.Tensor  # (B,) f32
    rep_penalty: torch.Tensor  # (B,) f32


@torch.no_grad()
def _prefill(model: T2SDecoder, phones, phone_len, bert, prompt, prompt_len, *, tx_max: int, tp_max: int,
             t_total: int):
    """Batched prefill of admitted requests (phones (b, tx_max) LEFT-padded,
    prompt (b, tp_max) RIGHT-padded) -> their cache rows k, v (L, b, T, H,
    Dh), masks (b, T) and presence, and the first logits (b, V) from the
    plain decode step on the unquantized rows, at the scratch slot (the
    prefix stage of `generate`'s plain path)."""
    cfg = model.cfg
    dev = phones.device
    b = phones.shape[0]
    rows = torch.arange(b, device=dev)
    ar = torch.arange(tx_max, device=dev)
    x_valid = ar[None, :] >= (tx_max - phone_len[:, None])
    x_pos = torch.clamp(ar[None, :] - (tx_max - phone_len[:, None]), min=0)
    arp = torch.arange(tp_max, device=dev)
    p_valid = arp[None, :] < prompt_len[:, None]
    p_pos = torch.clamp(arp[None, :], 0, cfg.max_len - 1).expand(b, tp_max)
    x_emb = model.embed_text(phones, bert, x_pos) * x_valid[..., None]
    p_emb = model.embed_audio(prompt, p_pos) * p_valid[..., None]
    _, k_pre, v_pre = model.prefill(torch.cat([x_emb, p_emb], dim=1), build_prefix_attn_bias(x_valid, p_valid))
    scratch = tx_max + tp_max
    pad_t = t_total - scratch
    k_rows = F.pad(k_pre, (0, 0, 0, 0, 0, pad_t)).contiguous()
    v_rows = F.pad(v_pre, (0, 0, 0, 0, 0, pad_t)).contiguous()
    valid = torch.cat([x_valid, p_valid, torch.zeros((b, pad_t), dtype=torch.bool, device=dev)], dim=1)
    last_pos = torch.clamp_min(prompt_len - 1, 0)
    last_emb = model.embed_audio(prompt.gather(1, last_pos[:, None]), last_pos[:, None])
    first_logits = model.decode_step(last_emb, k_rows, v_rows, valid, scratch)
    presence = torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
    presence[rows[:, None], torch.where(p_valid, prompt, torch.full_like(prompt, cfg.eos_id))] = True
    presence[:, cfg.eos_id] = False
    return k_rows, v_rows, valid, presence, first_logits


@dataclasses.dataclass
class _Request:
    rid: int
    phones: np.ndarray
    bert: np.ndarray
    prompt: np.ndarray
    seed: int
    top_k: int
    top_p: float
    temperature: float
    rep_penalty: float
    enqueued_ns: int  # perf_counter_ns at submit


class _Fetch:
    """A non-blocking device-to-host copy and the event that marks it done
    (on the CPU the copy is done when it returns)."""

    def __init__(self, src: torch.Tensor):
        cuda = src.device.type == "cuda"
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
        self.host.copy_(src, non_blocking=cuda)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(src.device))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@functools.cache
def _cu_graph_launch():
    """The driver's cuGraphLaunch(exec, stream), through `ctypes.PyDLL`: a
    call that keeps the interpreter lock."""
    fn = ctypes.PyDLL("libcuda.so.1").cuGraphLaunch
    fn.argtypes, fn.restype = (ctypes.c_void_p, ctypes.c_void_p), ctypes.c_int
    return fn


class _TailGraph:
    """A pool step's tail captured as one CUDA graph, replayed on the
    current stream. The capture stream first runs the tail eagerly, which
    is the current step's own work and makes that stream's cuBLAS and sort
    workspaces, then records it; the thread-local capture mode leaves the
    other threads (the S2 finishers) free to launch meanwhile."""

    def __init__(self, tail, device):
        self.device = device
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            tail()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                tail()
            finally:
                self.graph.capture_end()
        cur.wait_stream(side)
        self._exec = ctypes.c_void_p(self.graph.raw_cuda_graph_exec())

    def replay(self) -> None:
        """The graph's launch on the current stream, with the interpreter
        lock held. `CUDAGraph.replay` releases the lock around its launch,
        and a torch.profiler session stopping on another thread, which
        holds the lock through `_disable_profiler`, deadlocked with such a
        launch. Held, a launch and a profiler's start or stop never overlap.
        The tail draws no device random numbers, so the launch is the whole
        replay (torch's adds only its generators' offsets)."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = _cu_graph_launch()(self._exec, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"cuGraphLaunch failed: CUresult {rc}")


class ContinuousBatcher:
    """Host-side scheduler over the slot pool.

    submit() enqueues; step(n) runs one scheduler pass: apply the flag
    copies that have reached the host, evict finished rows and start the
    copies of their tokens, admit queued requests with one batched
    prefill, run the next segment of n steps, and start the flag copy for
    a later pass. Results surface a pass or more after the segment where
    the row finished; drain() loops until the pool is empty. Requests join
    at segment boundaries instead of waiting out a whole batch.

    use_fused: run each step through K1 (ops/decode_step.py
    fused_decode_step; its twin on CPU tensors). None: on a card, where K1
    takes 1..MAX_ROWS rows, so a larger pool raises instead of falling back
    to the plain step; the plain step on the CPU. False: the plain step,
    the caller's choice. Both work on the same K||V cache layout.

    On a card in fused mode each step's tail is a CUDA graph replay
    (`graph_captures` counts the captures: one a pool).
    """

    def __init__(
        self,
        model: T2SDecoder,
        *,
        slots: int = 8,
        tx_max: int = 160,
        tp_max: int = 256,
        max_new: int = 500,
        top_k: int = 15,
        top_p: float = 1.0,
        temperature: float = 1.0,
        repetition_penalty: float = 1.35,
        seed: int = 0,
        use_fused: Optional[bool] = None,
        weight_quant: str = "bf16",
        kv_quant: str = "bf16",
        fused_weights: Optional[dict] = None,
        lookahead: Optional[int] = None,
        device=None,
    ):
        cfg = model.cfg
        dev = self.device = resolve_device(device)
        self.slots, self.tx_max, self.tp_max, self.max_new = slots, tx_max, tp_max, max_new
        self.scratch = tx_max + tp_max
        self.t_total = -(-(tx_max + tp_max + 1 + max_new) // 512) * 512
        self.defaults = dict(top_k=top_k, top_p=top_p, temperature=temperature,
                             repetition_penalty=repetition_penalty)
        if kv_quant not in ("bf16", "int8"):
            raise ValueError(f"kv quant {kv_quant!r}: expected 'bf16' or 'int8'")
        if use_fused is None:
            use_fused = dev.type == "cuda"
        self.use_fused = use_fused
        self.kv_quant = use_fused and kv_quant == "int8"
        b, n_l, d, h = slots, cfg.num_layers, cfg.hidden_dim, cfg.num_heads
        if use_fused:  # refused before any work
            if dev.type == "cuda" and not 1 <= slots <= ds.MAX_ROWS:
                raise ValueError(f"the fused S1 step takes 1..{ds.MAX_ROWS} rows, got a pool of {slots} slots "
                                 "(use_fused=False runs the plain step)")
            # the largest write slot is scratch + max_new - 1: the last step's sweep
            self.plan_sweep = self.scratch + max_new
            ds.check_step_request(dev, d, cfg.ffn_dim, h, self.plan_sweep, self.kv_quant)
        self.model = model.to(dev).eval()
        kv_dtype = torch.float32
        if use_fused:
            if fused_weights is None:
                fused_weights = ds.stack_weights_from_params(model.state_dict(), n_l, quant=weight_quant)
            self.fused_weights = {k: v.to(dev) for k, v in fused_weights.items()}
            self.head = model.ar_predict_layer.weight.float()
            kv_dtype = torch.int8 if self.kv_quant else torch.bfloat16
        self.state = _SlotState(
            kv=torch.zeros((n_l, b, self.t_total, 2 * d), dtype=kv_dtype, device=dev),
            kv_scales=torch.zeros((n_l, b, 2, self.t_total), device=dev) if self.kv_quant else None,
            mask=torch.zeros((b, self.t_total), device=dev),
            presence=torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev),
            tok_emb=torch.zeros((b, 1, cfg.embedding_dim), device=dev),
            tokens=torch.zeros((b, max_new), dtype=torch.long, device=dev),
            gen_count=torch.zeros((b,), dtype=torch.long, device=dev),
            lengths=torch.zeros((b,), dtype=torch.long, device=dev),
            prompt_lens=torch.zeros((b,), dtype=torch.long, device=dev),
            active=torch.zeros((b,), dtype=torch.bool, device=dev),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
            top_k=torch.full((b,), top_k, dtype=torch.long, device=dev),
            top_p=torch.full((b,), top_p, device=dev),
            temperature=torch.full((b,), temperature, device=dev),
            rep_penalty=torch.full((b,), repetition_penalty, device=dev),
        )
        self._rows = torch.arange(b, device=dev)
        # what the step's tail reads besides the slot state, at addresses
        # fixed for a graph's replays: K1's output, a segment's write slots
        # and uniforms (up to max_new steps, B), the step's row of them
        self._y = torch.zeros((b, d), device=dev) if use_fused else None
        self._x = self.state.tok_emb[:, 0]  # K1's input: a view of the last tokens' embeddings
        self._slots_dev = torch.zeros((max_new, b), dtype=torch.long, device=dev)
        self._uniform_dev = torch.zeros((max_new, b), device=dev)
        self._step_i = torch.zeros((1,), dtype=torch.long, device=dev)
        self._graph: Optional[_TailGraph] = None
        self.graph_captures = 0
        # the plain step's K and V caches (L, B, T, H, Dh): views of the K||V halves
        kv6 = self.state.kv.view(n_l, b, self.t_total, 2, h, d // h)
        self._kv_halves = (kv6[:, :, :, 0], kv6[:, :, :, 1])
        self._seeds = np.random.default_rng(seed)
        # submit() runs on request threads while step() runs on the scheduler
        # thread: the queue and the seed stream need a mutex (everything else
        # is the scheduler thread's)
        self._submit_lock = threading.Lock()
        self._queue: list[_Request] = []
        self._slot_rid: list[Optional[int]] = [None] * slots
        self._slot_gen: list[int] = [-1] * slots  # segment count at install
        self._count = np.zeros(slots, np.int64)  # host mirror of gen_count (0: empty slot)
        self._draws: list[Optional[np.random.Generator]] = [None] * slots  # each row's uniform stream
        self._next_rid = 0
        self._len_seen = np.zeros(slots, np.int64)  # each row's length as the last flag copy read it
        self._pass_sync_ns = self._pass_sync_cpu_ns = 0  # the current pass's blocked copy waits
        self._segments_run = 0
        self.steps_run = 0  # pool steps (one K1 launch each in fused mode)
        self.peak_live = 0  # most rows a flag copy saw live at once
        # flag copies in flight to the host. The scheduler blocks on the
        # oldest only once more than `lookahead` are in flight, so the
        # device keeps decoding while the copies complete; done-detection
        # (and so slot reuse) lags by up to that many segments.
        # (_Fetch of (2, B): done, lengths; segment count at capture; perf_counter_ns at capture)
        self._flag_q: deque = deque()
        self.lookahead = int(os.environ.get("GSVT_CB_LOOKAHEAD", "2")) if lookahead is None else lookahead
        self._token_fetches: list[tuple[list, list, list, _Fetch]] = []  # (rids, lens, slots, copy)
        # slots whose token copy has not completed are not reinstalled, as in
        # the JAX pool (there an install donated the pool it read from)
        self._slot_hold: set[int] = set()

    # -- public API ---------------------------------------------------------

    def warmup(self, segment: int = 25) -> None:
        """One full admission (prefill, install, first draw), one segment
        of steps and its flag copy, so that the first real requests pay no
        first-use cost (K1's build, the allocator's growth, on a card the
        tail's graph capture); then the dummy rows are dropped where they
        stand and the pool is left empty."""
        cfg = self.model.cfg
        dummy = (np.ones(4, np.int64), np.zeros((4, cfg.bert_dim), np.float32), np.zeros(4, np.int64))
        for _ in range(self.slots):
            self.submit(*dummy)
        self.step(segment)
        self._slot_rid = [None] * self.slots
        self._count[:] = 0
        self._draws = [None] * self.slots
        self.state.active.zero_()
        while self._flag_q:  # speaks for no tenant now
            self._consume_ready_flags(force_oldest=True)

    def submit(
        self,
        phones,
        bert=None,
        prompt=None,
        *,
        seed: Optional[int] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
    ) -> int:
        """phones: (tx,) ids; bert: (tx, bert_dim) or None; prompt: (tp,) ids.
        Sampling options are per request; `seed` pins the request's stream of
        draws, so its tokens do not depend on its co-tenants."""
        phones = np.asarray(phones, np.int64)
        if phones.shape[0] > self.tx_max:
            raise ValueError(f"phones length {phones.shape[0]} > tx_max {self.tx_max}")
        prompt = np.asarray(prompt if prompt is not None else [0], np.int64)
        if prompt.shape[0] > self.tp_max:
            raise ValueError(f"prompt length {prompt.shape[0]} > tp_max {self.tp_max}")
        if bert is None:
            bert = np.zeros((phones.shape[0], self.model.cfg.bert_dim), np.float32)
        d = self.defaults
        with self._submit_lock:
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append(_Request(
                rid, phones, np.asarray(bert, np.float32), prompt,
                int(self._seeds.integers(2**63)) if seed is None else int(seed),
                d["top_k"] if top_k is None else int(top_k),
                d["top_p"] if top_p is None else float(top_p),
                d["temperature"] if temperature is None else float(temperature),
                d["repetition_penalty"] if repetition_penalty is None else float(repetition_penalty),
                time.perf_counter_ns(),
            ))
        return rid

    @torch.no_grad()
    def step(self, n: int = 25) -> dict[int, np.ndarray]:
        """One scheduler pass (see the class docstring). Returns {rid:
        tokens} of the requests whose results arrived in this pass."""
        seq = _REC.begin(_PASS)
        cpu0 = time.thread_time_ns()
        self._pass_sync_ns = self._pass_sync_cpu_ns = 0
        steps = rows = 0
        try:
            # flags already on the host cost nothing to act on now, and free
            # slots for this pass's admissions
            self._consume_ready_flags()
            self._admit_batch()
            rows = sum(r is not None for r in self._slot_rid)
            if rows:
                steps = n
                self._segment(n)
                self._segments_run += 1
                self._flag_q.append((_Fetch(torch.stack([self.state.done.long(), self.state.lengths])),
                                     self._segments_run, time.perf_counter_ns()))
                if len(self._flag_q) > self.lookahead:
                    self._consume_ready_flags(force_oldest=True)
                return self._resolve_token_fetches(block=False)
            while self._flag_q:  # idle pool: flush everything in flight
                self._consume_ready_flags(force_oldest=True)
            return self._resolve_token_fetches(block=True)
        finally:
            cpu = time.thread_time_ns() - cpu0 - self._pass_sync_cpu_ns
            _REC.end(seq, steps, cpu, self._pass_sync_ns, rows)

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slot_rid) + len(self._token_fetches)

    def drain(self, n: int = 25, max_segments: int = 10000) -> dict[int, np.ndarray]:
        out: dict[int, np.ndarray] = {}
        for _ in range(max_segments):
            if not self.pending:
                break
            out.update(self.step(n))
        return out

    # -- admission ----------------------------------------------------------

    def _admit_batch(self) -> None:
        """Admit up to `free slots` queued requests with one batched prefill
        and one install."""
        free = [s for s in range(self.slots) if self._slot_rid[s] is None and s not in self._slot_hold]
        if not free or not self._queue:
            return
        with self._submit_lock:
            take = min(len(free), len(self._queue))
            reqs = [self._queue.pop(0) for _ in range(take)]
        admit = _REC.begin(_ADMIT)
        t_admit = time.perf_counter_ns()
        for r in reqs:
            _REC.record(_QUEUE, r.enqueued_ns, t_admit, r.rid)
        slots = free[:take]
        tx, tp = self.tx_max, self.tp_max
        phones = np.zeros((take, tx), np.int64)
        phone_len = np.zeros((take,), np.int64)
        bert = np.zeros((take, tx, self.model.cfg.bert_dim), np.float32)
        prompt = np.zeros((take, tp), np.int64)
        prompt_len = np.zeros((take,), np.int64)
        for i, r in enumerate(reqs):
            phones[i, tx - len(r.phones):] = r.phones  # left-pad
            phone_len[i] = len(r.phones)
            bert[i, tx - len(r.phones):] = r.bert
            prompt[i, : len(r.prompt)] = r.prompt  # right-pad
            prompt_len[i] = len(r.prompt)
        dev = self.device
        seq = _REC.begin(_PREFILL)
        k_rows, v_rows, valid, presence, first_logits = _prefill(
            self.model, *(self._to_device(a) for a in (phones, phone_len, bert, prompt, prompt_len)),
            tx_max=tx, tp_max=tp, t_total=self.t_total,
        )
        _REC.end(seq, take)
        seq = _REC.begin(_DRAW)
        draws = [np.random.Generator(np.random.Philox(r.seed)) for r in reqs]
        params = self._row_params(reqs)
        fl = first_logits.float()
        fl[:, self.model.cfg.eos_id] = float("-inf")
        uniform = self._to_device(np.array([g.random(dtype=np.float32) for g in draws]))
        tok0 = sample_token_rows(fl, presence, *params, uniform)
        presence[torch.arange(take, device=dev), tok0] = True
        pl = self._to_device(prompt_len)
        tok0_emb = self.model.embed_audio(tok0[:, None], pl[:, None])
        _REC.end(seq, take)
        seq = _REC.begin(_INSTALL)
        self._install_rows(self._to_device(np.array(slots)), k_rows, v_rows, valid, presence, tok0, tok0_emb, pl,
                           params)
        for r, s, g in zip(reqs, slots, draws):
            self._slot_rid[s] = r.rid
            self._slot_gen[s] = self._segments_run
            self._count[s] = 1
            self._len_seen[s] = 1  # the first token, which the admission samples
            self._draws[s] = g
        _REC.end(seq, take)
        _REC.end(admit, take)

    def _row_params(self, reqs):
        """(top_k, top_p, temperature, rep_penalty) of the requests, (k,)
        tensors on the pool's device."""
        return (self._to_device(np.array([r.top_k for r in reqs], np.int64)),
                self._to_device(np.array([r.top_p for r in reqs], np.float32)),
                self._to_device(np.array([r.temperature for r in reqs], np.float32)),
                self._to_device(np.array([r.rep_penalty for r in reqs], np.float32)))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array to the device by a plain copy from pageable memory,
        which on a card first waits for the stream to drain: that wait is
        timed into the pass's copy waits (`pool.sync_upload`)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
        out = t.to(self.device)
        self._blocked(_SYNC_UPLOAD, t0, c0)
        return out

    def _install_rows(self, sl, k_rows, v_rows, valid, presence, tok0, tok0_emb, prompt_len, params):
        """Write k prefilled requests into the pool slots `sl` (k,), in
        place: the rows as one K||V, in bf16 for K1, quantized once here in
        int8-KV mode (as `generate` quantizes its prefix)."""
        s = self.state
        n_l, k, t = k_rows.shape[:3]
        kv = torch.cat([k_rows.reshape(n_l, k, t, -1), v_rows.reshape(n_l, k, t, -1)], dim=-1)
        if self.kv_quant:
            kv, scales = ds.quantize_kv_cache(kv.to(torch.bfloat16))
            s.kv_scales[:, sl] = scales
        s.kv[:, sl] = kv.to(s.kv.dtype)
        s.mask[sl] = valid.float()
        s.presence[sl] = presence
        s.tok_emb[sl] = tok0_emb.float()
        s.tokens[sl] = 0
        s.tokens[sl, 0] = tok0
        s.gen_count[sl] = 1
        s.lengths[sl] = 1
        s.prompt_lens[sl] = prompt_len
        s.active[sl] = True
        s.done[sl] = False
        s.top_k[sl], s.top_p[sl], s.temperature[sl], s.rep_penalty[sl] = params

    # -- decoding -----------------------------------------------------------

    def _segment(self, n: int) -> None:
        """Advance every installed row n steps; done and empty rows decode
        masked, their state untouched. The host works out every step's
        write slots (from its mirror of the step counts) and uniforms first,
        and sends each to the device in one copy a segment."""
        installed = np.array([r is not None for r in self._slot_rid])
        b = self.slots
        g = np.where(installed[None], np.minimum(self._count[None] + np.arange(n)[:, None], self.max_new), 0)
        slots = self.scratch + np.maximum(g - 1, 0)  # (n, B): the token sampled g - 1 steps ago
        uniform = np.zeros((n, b), np.float32)
        for i in np.flatnonzero(installed):
            uniform[:, i] = self._draws[i].random(n, dtype=np.float32)
        self._stage(slots, uniform)
        seq = _REC.begin(_SEGMENT)
        replays = 0
        for i in range(n):
            replays += self._decode_one(slots[i].tolist())
        _REC.count(_GRAPH_STEPS, replays)
        _REC.end(seq, n, int(installed.sum()))
        self._count = np.where(installed, np.minimum(self._count + n, self.max_new), 0)
        self.steps_run += n

    def _stage(self, slots: np.ndarray, uniform: np.ndarray) -> None:
        """A segment's write slots and uniforms (n, B) into the device
        buffers the tail reads its step's row from, one copy each (through
        pinned memory on a card: the copy does not block the host), and the
        step index back to row 0. The buffers hold max_new steps: by then
        every row the segment started with is done, so the steps of a
        longer segment after those read the last row."""
        n = min(slots.shape[0], self.max_new)
        cuda = self.device.type == "cuda"
        for a, dst in ((slots[:n], self._slots_dev), (uniform[:n], self._uniform_dev)):
            t = torch.from_numpy(np.ascontiguousarray(a))
            dst[:n].copy_(t.pin_memory() if cuda else t, non_blocking=cuda)
        self._step_i.zero_()

    def _graphable(self) -> bool:
        """Whether the step's tail runs as a CUDA graph: on a card, behind K1
        (the plain step's tail runs eagerly)."""
        return self.use_fused and self.device.type == "cuda"

    def _decode_one(self, write_idx: list) -> bool:
        """One pool step (`generate`'s loop body with per-row slots): in
        fused mode K1's launch with the rows' write slots as a host list,
        then the tail, a replay of its graph where the pool has one (the
        first step on a card captures it). Returns whether the tail was a
        replay."""
        if self.use_fused:
            s = self.state
            # K1 adds the query's own fresh K/V itself, so it gets the mask
            # from before the tail's update
            ds.fused_decode_step(self._x, self.fused_weights, s.kv, s.mask, write_idx, s.kv_scales,
                                 num_heads=self.model.cfg.num_heads, plan_sweep=self.plan_sweep, out=self._y)
        if self._graph is not None:
            self._graph.replay()
            return True
        if self._graphable():
            self._graph = _TailGraph(self._tail, self.device)
            self.graph_captures += 1
        else:
            self._tail()
        return False

    def _tail(self) -> None:
        """A pool step after K1: the mask write, the logits (the f32 head on
        K1's output, or the plain step), the EOS mask, the sampler and the
        state updates, for the step whose write slots and uniforms are row
        `_step_i` of the staged buffers; then `_step_i` moves on, to stop at
        the buffers' last row. Every
        tensor it reads or writes lives as long as the pool, and it reads
        nothing back to the host, so it can run as a CUDA graph."""
        s = self.state
        cfg = self.model.cfg
        eos = cfg.eos_id
        rows = self._rows
        write_dev = self._slots_dev.index_select(0, self._step_i)[0]
        uniform = self._uniform_dev.index_select(0, self._step_i)[0]
        live = s.active & ~s.done
        s.mask[rows, write_dev] = torch.maximum(s.mask[rows, write_dev], live.float())
        if self.use_fused:
            logits = F.linear(self._y, self.head)
        else:
            logits = self.model.decode_step(s.tok_emb, *self._kv_halves, s.mask > 0, write_dev)
        logits[:, eos] = torch.where(s.gen_count < EOS_MASK_WARMUP_STEPS, float("-inf"), logits[:, eos])
        argmax_is_eos = logits.argmax(-1) == eos
        tok = sample_token_rows(logits, s.presence, s.top_k, s.top_p, s.temperature, s.rep_penalty, uniform)
        newly_done = live & (argmax_is_eos | (tok == eos) | (s.gen_count >= self.max_new))
        keep = live & ~newly_done
        tok = torch.where(keep, tok, 0)
        write_pos = torch.clamp_max(s.gen_count, self.max_new - 1)
        s.tokens[rows, write_pos] = torch.where(keep, tok, s.tokens[rows, write_pos])
        s.lengths += keep
        s.done |= newly_done
        s.presence[rows, tok] |= live
        pos = torch.clamp(s.prompt_lens + s.gen_count, 0, cfg.max_len - 1)
        s.tok_emb.copy_(torch.where(live[:, None, None], self.model.embed_audio(tok[:, None], pos[:, None]), s.tok_emb))
        s.gen_count += keep
        self._step_i.add_(1).clamp_max_(self.max_new - 1)

    # -- results ------------------------------------------------------------

    def _consume_ready_flags(self, force_oldest: bool = False) -> None:
        """Apply flag copies from the front of the queue, in order: those
        already on the host, and with `force_oldest` the first one in any
        case (bounding the queue at `lookahead`, and draining at idle)."""
        while self._flag_q:
            fetch, gen, t_copy = self._flag_q[0]
            if not (force_oldest or fetch.ready()):
                return
            force_oldest = False
            self._flag_q.popleft()
            self._apply_flags(self._wait(fetch, _SYNC_FLAGS), gen, t_copy)

    def _wait(self, fetch: _Fetch, name: int) -> np.ndarray:
        """A copy's host array, its wait on the copy's event timed into the
        pass (wall and thread CPU time) and recorded as a span."""
        if fetch.event is None:
            return fetch.get()
        t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
        out = fetch.get()
        self._blocked(name, t0, c0)
        return out

    def _blocked(self, name: int, t0: int, c0: int) -> None:
        """Count a copy wait that started at `t0` (`perf_counter_ns`) and
        thread CPU time `c0` into the pass, and record it as a span."""
        cpu, t1 = time.thread_time_ns() - c0, time.perf_counter_ns()
        self._pass_sync_ns += t1 - t0
        self._pass_sync_cpu_ns += cpu
        _REC.record(name, t0, t1, -1, cpu)

    def _apply_flags(self, flags: np.ndarray, flag_gen: int, t_copy: int) -> None:
        """Evict the rows a flag copy reports done and start the copies of
        their tokens. A flag copy speaks only for tenants installed before
        it was captured: a copy older than a slot's install may still carry
        the previous tenant's done flag. The installed rows' growth in
        length since the copy before is counted at this copy's capture
        time `t_copy`."""
        done, lengths = flags
        evicted = []
        live = decoded = 0
        for slot in range(self.slots):
            rid = self._slot_rid[slot]
            if rid is None or flag_gen <= self._slot_gen[slot]:
                continue
            decoded += int(lengths[slot]) - int(self._len_seen[slot])
            self._len_seen[slot] = lengths[slot]
            if done[slot]:
                _REC.mark(_EVICT, rid, int(lengths[slot]))
                evicted.append((slot, rid, int(lengths[slot])))
                self._slot_rid[slot] = None
                self._count[slot] = 0
            else:
                live += 1
        _REC.count(_DECODED_ROW_STEPS, decoded, t_copy)
        self.peak_live = max(self.peak_live, live)
        if evicted:
            slots_e = [s for s, _, _ in evicted]
            rows = self.state.tokens.index_select(0, torch.tensor(slots_e, device=self.device))
            self._slot_hold.update(slots_e)
            self._token_fetches.append(([r for _, r, _ in evicted], [ln for _, _, ln in evicted], slots_e,
                                        _Fetch(rows)))

    def _resolve_token_fetches(self, block: bool) -> dict[int, np.ndarray]:
        out: dict[int, np.ndarray] = {}
        keep = []
        for rids, lens, slots_e, fetch in self._token_fetches:
            if not (block or fetch.ready()):
                keep.append((rids, lens, slots_e, fetch))
                continue
            for rid, ln, toks in zip(rids, lens, self._wait(fetch, _SYNC_TOKENS)):
                out[rid] = toks[:ln].copy()
            self._slot_hold.difference_update(slots_e)
        self._token_fetches = keep
        return out
