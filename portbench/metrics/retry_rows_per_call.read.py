"""retry_rows_per_call.read: per call, the rows the decoders decode a
second time at the escalated budget (the program's retried_rows
counter); 0 where no row errs at the default budget."""

from portbench.metrics._program import per_call, total_count


def read(run):
    return per_call(run, "decompress",
                    lambda recs: total_count(recs, "retried_rows"))
