"""Wire bytes the replicas received over the window, per coded symbol
their sessions used.  The check holds every session's symbols used to
the reference exactly, so on a given seed this moves one for one with
the bytes received; unlike bytes per record it does not swing with the
seed where differences are a few records each."""


def read(run):
    got = sum(rep.bytes_received for rep in run.reports)
    used = sum(rep.symbols_used for rep in run.reports)
    return got / used if used else None
