"""Host milliseconds a training step spends in the loss (exposure, L1, SSIM,
the depth term): the self time of the program's span `hlod.loss` inside
train_step."""

from benchmark.harness import spans

SPANS = ("hlod.loss",)


def read(r):
    return spans.self_ms(r, SPANS)
