"""Host milliseconds the completer thread spends on a batch: the mean,
over the batches whose ``serve.batch`` span began and ended in the
measured window before the profiler started (with rows), of the
``serve.fetch_tokens`` (``tokens.cpu()``) and ``serve.detokenize`` spans
that name the batch as parent. The completer holds the interpreter lock
for that long while the batcher fills, stacks and uploads the next
batch; the profiler does not record its thread, so only its spans show
it. The traced window's value goes to the log."""

from portbench import program_spans

program_spans.enable()

PARTS = ("serve.fetch_tokens", "serve.detokenize")


def value(got):
    batches = {s.id for s in program_spans.whole(got, "serve.batch")
               if "rows" in s.attrs}
    if not batches:
        return None
    return sum(s.ms for s in got["all"]
               if s.name in PARTS and s.parent in batches) / len(batches), \
        len(batches)


def read(ctx):
    return program_spans.reading(ctx, "serve", value,
                                 "serve.completer_ms_per_batch")
