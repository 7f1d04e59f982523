"""The host's milliseconds to issue one decode step: the mean, over the
``decode.step`` spans that began and ended in the measured window before
the profiler started, of the step's span less its ``decode.stop_check``
child (the device-to-host read that waits for the step to finish; the
traced window's value goes to the log). It reads every
``decode.enqueue_ms_per_step.<cells>`` metric."""

from portbench import program_spans

program_spans.enable()


def value(got):
    steps = program_spans.whole(got, "decode.step")
    if not steps:
        return None
    waits = {s.parent: s.ms for s in got["all"]
             if s.name == "decode.stop_check"}
    return sum(s.ms - waits.get(s.id, 0.0) for s in steps) / len(steps), \
        len(steps)


def read(ctx):
    return program_spans.reading(ctx, "serve", value,
                                 "decode.enqueue_ms_per_step")
