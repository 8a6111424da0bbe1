"""ms a step the device idled in the traced window while the host was in
the loop (camera, draws, Adam, the step's sync, the step's own Python): the program's spans (metrics/_spans.py)."""

from benchmark.metrics._spans import idle_ms


def read(run):
    return idle_ms(run, "loop")
