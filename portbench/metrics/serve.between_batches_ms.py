"""Host milliseconds a batch spends between decodes, on the batcher
thread: the mean, over the batches whose ``serve.batch`` span began and
ended in the measured window before the profiler started (with rows: not
a wait that timed out), of its ``serve.fill``, ``serve.stack``,
``serve.upload`` and ``serve.handoff`` spans (the program's own:
``program_spans``; the traced window's value goes to the log). It reads
every ``serve.between_batches_ms.<cells>`` metric."""

from portbench import program_spans

program_spans.enable()

PARTS = ("serve.fill", "serve.stack", "serve.upload", "serve.handoff")


def value(got):
    batches = {s.id for s in program_spans.whole(got, "serve.batch")
               if "rows" in s.attrs}
    if not batches:
        return None
    return sum(s.ms for s in got["spans"]
               if s.name in PARTS and s.parent in batches) / len(batches), \
        len(batches)


def read(ctx):
    return program_spans.reading(ctx, "serve", value,
                                 "serve.between_batches_ms")
