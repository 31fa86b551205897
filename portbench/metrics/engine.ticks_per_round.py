"""The engine's plan/execute ticks (``ReconcileEngine.ticks``) per round
of the traced window."""


def read(run):
    if not run.rounds:
        return None
    return sum(r.ticks for r in run.rounds) / len(run.rounds)
