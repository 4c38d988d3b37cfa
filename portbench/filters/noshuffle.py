"""No filter: the header's filter bits clear, the block as it is."""

NAME = "NOSHUFFLE"
CODE = 0
FLAG = 0


def undo(typesize: int, block):
    return block
