"""cfm_chunks_per_call: real chunks a batched CFM call, the mean over the
calls of the requests completed in the window (`TTSPipeline.last_cfm_batch`:
real chunks, against the bucket's padded ones)."""


def read(run):
    calls = [bs for r in run.done for bs, _ in r.get("cfm_batch", [])]
    return sum(calls) / len(calls) if calls else None
