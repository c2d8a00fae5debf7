"""submit_ms: the mean milliseconds of `ContinuousTTSService.submit` (the
text frontend and the enqueue, on the caller's thread), the benchmark's own
span around each call, over the requests completed in the window."""


def read(run):
    spans = [r["submit_s"] for r in run.done if "submit_s" in r]
    return 1e3 * sum(spans) / len(spans) if spans else None
