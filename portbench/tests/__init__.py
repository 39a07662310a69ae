"""CPU tests of the benchmark: the references against the port's CPU
forward, the frozen counts against the port's, the import rule, the
data-driven lookup, the control and the planted faults."""
