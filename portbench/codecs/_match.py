"""The match copy that the LZ77 decoders share."""


def copy_match(out: bytearray, ref: int, back: int, mlen: int) -> None:
    """Append mlen bytes copied from ``back`` bytes behind the end, byte
    after byte as the decoders define it: an overlapping match repeats
    its last ``back`` bytes."""
    if back >= mlen:
        out += out[ref:ref + mlen]
    else:
        pattern = out[ref:]
        out += (pattern * (mlen // back + 1))[:mlen]
