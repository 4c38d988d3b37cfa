"""copied_per_item_byte.getitem: bytes the getitem calls copied to and
from the card (the program's h2d_bytes and d2h_bytes counters) per byte
of the items they returned: the whole chunk in and whole blocks out for
a few hundred bytes. Over the calls the program recorded (its ring keeps
the newest), each returning the same number of bytes."""

from portbench.metrics._coded import getitem_records
from portbench.metrics._program import total_count


def read(run):
    got = getitem_records(run)
    if got is None or not run.latencies_s:
        return None
    recs, calls = got
    answer_bytes = calls * run.bytes_out / len(run.latencies_s)
    if not answer_bytes:
        return None
    return (total_count(recs, "h2d_bytes") +
            total_count(recs, "d2h_bytes")) / answer_bytes
