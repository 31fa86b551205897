"""Host waits for the card (``repro_torch.kernels.peel.read_back.count``)
per round of the traced window."""


def read(run):
    if not run.rounds:
        return None
    return sum(r.host_reads for r in run.rounds) / len(run.rounds)
