"""The 95th percentile of a request's wait before its batch's decode:
over the rows of the batches whose ``serve.batch`` span began in the
measured window before the profiler started, the start of the batch's
``serve.decode`` less the row's enqueue time (``serve.batch``'s
``t_enqueue``, the same clock; the traced window's value goes to the
log). It reads every ``serve.queue_wait_p95_ms.<cells>`` metric."""

from portbench import program_spans
from portbench.loadgen import percentile

program_spans.enable()


def value(got):
    decode_ms = {s.parent: s.ts / 1e3 for s in got["all"]
                 if s.name == "serve.decode"}
    waits = []
    for b in got["spans"]:
        if b.name == "serve.batch" and b.id in decode_ms:
            # t_enqueue is monotonic seconds: on the trace's clock by the
            # offset the records were placed with
            at = decode_ms[b.id] - got["offset_ns"] / 1e6
            waits += [at - t * 1e3 for t in b.attrs.get("t_enqueue", ())]
    return (percentile(waits, 95), len(waits)) if waits else None


def read(ctx):
    return program_spans.reading(ctx, "serve", value,
                                 "serve.queue_wait_p95_ms")
