"""The byte shuffle (c-blosc's ``shuffle-generic.h``), header flag bit 0."""

NAME = "SHUFFLE"
CODE = 1
FLAG = 0x01


def undo(typesize: int, block):
    """Undo the byte shuffle (shuffle-generic.h:54-81): the first
    n // typesize * typesize bytes were transposed, the rest copied."""
    n = block.size
    if typesize <= 1:
        return block.copy()
    nel = n // typesize
    out = block.copy()
    out[:nel * typesize] = (
        block[:nel * typesize].reshape(typesize, nel).T.reshape(-1))
    return out
