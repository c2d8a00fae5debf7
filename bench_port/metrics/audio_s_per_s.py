"""audio_s_per_s: seconds of int16 audio in the requests completed inside
the window, over the seconds from the window's start to the last of those
completions (the benchmark's clock)."""


def read(run):
    if not run.done or run.window_s <= 0:
        return None
    return sum(len(r["audio"]) / r["sr"] for r in run.done) / run.window_s
