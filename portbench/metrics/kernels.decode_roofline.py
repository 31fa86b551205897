"""The decode's share of its bytes bound, in %.

The bound is the bytes the window's decodes need at the card's memory
rate: every symbol a session used read once, every recovered record and
its checksum written once (``portbench.peaks.decode_bytes``).  The time
is the card's busy time over the traced window (every kernel and copy,
merged); in these cells all of it is the decode.
"""
from portbench import peaks


def read(run):
    if run.device is None or run.device["busy_s"] <= 0:
        return None
    need = sum(peaks.decode_bytes(
        rep.symbols_used, rep.only_remote.shape[0] + rep.only_local.shape[0],
        run.L) for rep in run.reports)
    if not need:
        return None
    return 100.0 * peaks.bound_seconds(need) / run.device["busy_s"]
