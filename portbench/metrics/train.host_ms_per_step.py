"""The host's milliseconds a CE step: the mean of the program's
``train.step`` spans that began and ended in the measured window before
the profiler started (to set beside the device's busy seconds a step;
the traced window's value goes to the log)."""

from portbench import program_spans

program_spans.enable()


def value(got):
    steps = program_spans.whole(got, "train.step")
    return (sum(s.ms for s in steps) / len(steps), len(steps)) \
        if steps else None


def read(ctx):
    return program_spans.reading(ctx, "train", value,
                                 "train.host_ms_per_step")
