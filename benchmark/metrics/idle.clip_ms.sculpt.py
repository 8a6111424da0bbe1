"""ms a step the device idled in the traced window while the host was in
CLIP's image encode: the program's spans (metrics/_spans.py)."""

from benchmark.metrics._spans import idle_ms


def read(run):
    return idle_ms(run, "clip")
