"""Host milliseconds a training step spends in the backward pass (the call into
torch.autograd.grad, kernel B2 and the per-Gaussian reductions included): the
self time of the program's span `hlod.backward` inside train_step."""

from benchmark.harness import spans

SPANS = ("hlod.backward",)


def read(r):
    return spans.self_ms(r, SPANS)
