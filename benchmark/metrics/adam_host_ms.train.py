"""Host milliseconds a training step spends in the optimizer (densification
statistics, the masked Adam, the big-Gaussian shrink, the new state): the self
time of the program's span `hlod.adam` inside train_step."""

from benchmark.harness import spans

SPANS = ("hlod.adam",)


def read(r):
    return spans.self_ms(r, SPANS)
