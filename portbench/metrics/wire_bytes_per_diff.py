"""Wire bytes the replicas received over the window, per differing
record recovered."""


def read(run):
    got = sum(rep.bytes_received for rep in run.reports)
    items = sum(rep.only_remote.shape[0] + rep.only_local.shape[0]
                for rep in run.reports)
    return got / items if items else None
