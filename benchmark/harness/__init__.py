"""The harness: discovery by name, inputs from the seed, the timed window,
the trace's reduction and the comparison with the reference."""
