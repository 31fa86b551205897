"""Differing records recovered exactly, over every round the window
completed, per second of the window (host clock)."""


def read(run):
    items = sum(rep.only_remote.shape[0] + rep.only_local.shape[0]
                for rep in run.reports)
    return items / run.window_s if run.window_s > 0 and items else None
