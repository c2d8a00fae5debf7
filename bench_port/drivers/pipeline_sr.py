"""Driver `pipeline_sr`: the `pipeline` driver's requests (`TTSPipeline.run`,
the batched branch) with super-sampling on, as `run` leaves it where the
bundle has an AP-BWE `sr_model`.

Besides what the `pipeline` driver records, a span around each call of
`super_resolve` in `infer/pipeline.py`'s namespace records AP-BWE's input
(a segment's 24 kHz waveform, after BigVGAN and SOLA) and its output (the
48 kHz waveform, copied off the card after the request), so that the
reference can judge AP-BWE apart from the stages before it.
"""

from __future__ import annotations

from bench_port.drivers.pipeline import Pipeline


class PipelineSR(Pipeline):
    def __init__(self, pipe, cfg: dict, mix: dict):
        super().__init__(pipe, cfg, mix)
        self._sr = self.module.super_resolve
        self.module.super_resolve = self._spy_sr

    def _spy_sr(self, model, audio, orig_sr):
        out, rate = self._sr(model, audio, orig_sr)
        self._groups[-1].setdefault("sr", []).append((audio[0], out[0]))
        return out, rate

    def call(self, req: dict) -> dict:
        out = super().call(req)
        for g, seen in zip(out["groups"], self._groups):
            g["sr_in"] = [x for x, _ in seen.get("sr", [])]
            g["sr_out"] = [y.cpu().numpy() for _, y in seen.get("sr", [])]
        return out

    def close(self) -> None:
        super().close()
        self.module.super_resolve = self._sr


Driver = PipelineSR
