"""Driver `service`: requests through `ContinuousTTSService` (submit, then
result), the S1 slot pool in the configuration's serving layout."""

from __future__ import annotations

import time


class Service:
    """`start`, `ready` and `finish` a request: the benchmark's dispatcher
    keeps the mix's callers' requests in flight from one thread."""

    def __init__(self, pipe, cfg: dict, mix: dict):
        from gpt_sovits_tpu_torch.serve.continuous_service import ContinuousTTSService

        s = cfg["serving"]
        self.pipe, self.mix = pipe, mix
        self.svc = ContinuousTTSService(pipe, slots=s["slots"], segment=s["segment"], tx_max=s["tx_max"],
                                        tp_max=s["tp_max"], max_new=s["max_new"])

    def warm(self, requests: list) -> None:
        """The given requests at once (one of each size the mix sends), so
        the window meets no first call of a shape."""
        jobs = [self.svc.submit(r["text"], self.mix["language"], seed=r["seed"], **r["sampling"]) for r in requests]
        for job in jobs:
            self.svc.result(job, timeout=600)

    def start(self, req: dict, rec: dict):
        """Submit; the benchmark's span around `submit` goes into `rec`."""
        t0 = time.perf_counter()
        job = self.svc.submit(req["text"], self.mix["language"], seed=req["seed"], **req["sampling"])
        rec["submit_s"] = time.perf_counter() - t0
        return job

    def ready(self, job) -> bool:
        return job.done.is_set()

    def finish(self, job) -> dict:
        sr, audio = self.svc.result(job, timeout=600)
        return {"audio": audio, "sr": sr, "tokens": [job.tokens[r] for r in job.rids],
                "phones": [list(s["phones"]) for s in job.segments]}

    def counters(self) -> dict:
        return {"pool_steps": self.svc.cb.steps_run}

    def close(self) -> None:
        self.svc.close()


Driver = Service
