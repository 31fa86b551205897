"""95th percentile of every round's duration in the window, in ms: the
time until the node is in sync with each replica of the round (host
clock; linear interpolation between the two nearest rounds)."""
import numpy as np


def read(run):
    if not run.rounds:
        return None
    return float(np.percentile([r.seconds for r in run.rounds], 95)) * 1e3
