"""Driver `pipeline`: requests through `TTSPipeline.run` (the batched
branch, `parallel_infer=True`).

Two spans around calls into the pipeline's layers record what a request
served, from outside the pipeline: each call of S1's `generate` (the rows'
phones and the served tokens) and each batched CFM call (its output mel).
The CFM call's initial noise is the benchmark's, drawn from the request's
seed (`noise_seed`), so that the reference can be given the same.
"""

from __future__ import annotations

import torch

from bench_port.weights import stream_seed


def noise_seed(req_seed: int, call: int) -> int:
    return stream_seed(req_seed, f"cfm_noise:{call}")


def cfm_noise(shape, req_seed: int, call: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(noise_seed(req_seed, call))
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)


class Pipeline:
    def __init__(self, pipe, cfg: dict, mix: dict):
        from gpt_sovits_tpu_torch.infer import pipeline as module

        self.pipe, self.mix, self.module = pipe, mix, module
        self._groups: list = []
        self._seed = 0
        self._generate, self._cfm = module.generate, module.cfm_inference
        module.generate, module.cfm_inference = self._spy_generate, self._spy_cfm

    def _spy_generate(self, model, phoneme_ids, phoneme_lens, *args, **kw):
        out = self._generate(model, phoneme_ids, phoneme_lens, *args, **kw)
        tx = phoneme_ids.shape[1]
        self._groups.append({"rows": (phoneme_ids, phoneme_lens, tx), "result": out})
        return out

    def _spy_cfm(self, dit, mu, *args, noise=None, **kw):
        call = sum("mel" in g for g in self._groups)
        noise = cfm_noise(noise.shape, self._seed, call, mu.device)
        mel = self._cfm(dit, mu, *args, noise=noise, **kw)
        self._groups[-1]["mel"] = mel
        return mel

    def warm(self, requests: list) -> None:
        for r in requests:
            self.call(r)

    def call(self, req: dict) -> dict:
        self._groups, self._seed = [], req["seed"]
        sr, audio = self.pipe.run(req["text"], self.mix["language"], seed=req["seed"], max_sec=req["max_sec"],
                                  parallel_infer=True, **req["sampling"])
        groups = []
        for g in self._groups:
            ids, lens, tx = g["rows"]
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            toks, n = g["result"].tokens.cpu().numpy(), g["result"].lengths.cpu().numpy()
            groups.append({"phones": [list(ids[i, tx - lens[i]:]) for i in range(len(lens))],
                           "tokens": [toks[i, : n[i]] for i in range(len(n))], "mel": g["mel"].cpu(),
                           "noise_call": len(groups)})
        return {"audio": audio, "sr": sr, "groups": groups, "timing": dict(self.pipe.last_timing),
                "cfm_batch": [tuple(b) for b in self.pipe.last_cfm_batch]}

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.module.generate, self.module.cfm_inference = self._generate, self._cfm


Driver = Pipeline
