"""Seconds from the process's start to the first timed round: the
imports, the kernels' build or load, the generated sets, the node's and
the replicas' encoders warmed to the cell's stream length, and the
warm-up rounds (host clock)."""


def read(run):
    return run.setup_s
