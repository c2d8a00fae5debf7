"""vocoder_phase_s_per_audio_s: the `vocoder` phase of `TTSPipeline.run`'s
`last_timing` (closed by a device sync), summed over the requests completed
in the window but the profiled ones, over their seconds of audio."""


def read(run):
    recs = [r for r in run.done if "timing" in r and not r.get("profiled")]
    audio = sum(len(r["audio"]) / r["sr"] for r in recs)
    return sum(r["timing"].get("vocoder", 0.0) for r in recs) / audio if audio > 0 else None
