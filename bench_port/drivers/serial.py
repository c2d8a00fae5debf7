"""Driver `serial`: one caller's requests through `TTSPipeline.run` alone,
as the reference project's default batched inference runs them: the
segments sorted by length and cut into batches of up to the mix's
`batch_size`, S1's `generate` loop and S2 a batch (`parallel_infer=True`),
no serving pool.

The `pipeline` driver's span around each call of S1's `generate` records
each row's phones and served tokens; a request returns them in reading
order (each row at the first unused sentence of its phones), as the v2
family's `check` and `metrics/mfu.py` read them.
"""

from __future__ import annotations

from bench_port import traffic
from bench_port.drivers.pipeline import Pipeline
from bench_port.families.cfm import reading_order


class Serial(Pipeline):
    def __init__(self, pipe, cfg: dict, mix: dict):
        super().__init__(pipe, cfg, mix)
        self.sentences = traffic.load(mix["sentences"])

    def call(self, req: dict) -> dict:
        self._groups = []
        sr, audio = self.pipe.run(req["text"], self.mix["language"], seed=req["seed"], max_sec=req["max_sec"],
                                  parallel_infer=True, batch_size=self.mix["batch_size"], **req["sampling"])
        phones, tokens = [], []
        for g in self._groups:
            ids, lens, tx = g["rows"]
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            toks, n = g["result"].tokens.cpu().numpy(), g["result"].lengths.cpu().numpy()
            phones += [list(ids[i, tx - lens[i]:]) for i in range(len(lens))]
            tokens += [toks[i, : n[i]] for i in range(len(n))]
        order = reading_order(req, self.sentences, phones)
        if None not in order:  # else the rows stay in batch order, and `check` finds the phones wrong
            rows = sorted(range(len(order)), key=order.__getitem__)
            phones, tokens = [phones[i] for i in rows], [tokens[i] for i in rows]
        return {"audio": audio, "sr": sr, "tokens": tokens, "phones": phones, "timing": dict(self.pipe.last_timing)}


Driver = Serial
