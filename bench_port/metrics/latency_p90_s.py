"""latency_p90_s: the 90th percentile, over every request completed in the
window, of the seconds from its submit to the int16 audio its result
returns; a request that failed in the window counts as beyond any limit."""

import math

import numpy as np


def read(run):
    lat = [r["done"] - r["sent"] for r in run.done]
    lat += [math.inf for r in run.records if "error" in r and r["done"] <= run.t_end]
    if not lat:
        return None
    return float(np.percentile(np.array(lat), 90))
