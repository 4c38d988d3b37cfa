"""copy_amplification.read: bytes the decompress calls copied to and
from the card (the program's h2d_bytes and d2h_bytes counters) over the
bytes they took and returned; 1.0 moves each byte in and out once."""

from portbench.metrics._program import copy_amplification


def read(run):
    return copy_amplification(run, "decompress")
