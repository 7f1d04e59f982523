"""Host milliseconds the prefetch producer spends uploading one CE
step's batch: its ``data.upload`` spans that began and ended in the
measured window before the profiler started, over the ``train.step``
spans that did. The producer's thread holds the interpreter lock for
part of that while the training loop issues the step; the profiler does
not record that thread, so only its spans show it. The traced window's
value goes to the log."""

from portbench import program_spans

program_spans.enable()


def value(got):
    steps = program_spans.whole(got, "train.step")
    if not steps:
        return None
    return sum(s.ms for s in program_spans.whole(got, "data.upload")) \
        / len(steps), len(steps)


def read(ctx):
    return program_spans.reading(ctx, "train", value,
                                 "data.upload_ms_per_step")
