"""The benchmark's plain reference: the modem's geometry, score planes,
state machine and loopback synthesis in plain NumPy and PyTorch, worked
out again from the benchmark's own inputs.  Imports nothing of the
program under test."""
