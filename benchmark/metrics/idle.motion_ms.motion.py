"""ms a step the device idled in the traced window while the host was in
the motion decoder's layer (``motion.decode``, ``motion.loss``): the
program's spans (metrics/_spans.py). Nothing where the program opens no
``motion`` span (a program without them)."""

from benchmark.metrics._spans import idle_ms, program_spans


def read(run):
    spans = program_spans()
    if not spans or not any(s.name.split(".", 1)[0] == "motion" for s in spans):
        return None
    return idle_ms(run, "motion")
