"""Metrics logging (port of hlod_gaussians_tpu/utils/metrics.py's JSONL
stream) and the port's own tracing: spans and counters.

`MetricsLogger` replaces the reference's TensorBoard SummaryWriter
(train_post.py:46-56, 650-673) with a JSONL metrics stream.

`span(name)` marks a stretch of host code on torch.profiler's clock. The
port opens `hlod.*` spans inside its entry points: `hlod.train_step`
(train/flat.py) around `hlod.project`, `hlod.bin` and `hlod.blend`
(render.render_params, as render.render_arrays opens them), `hlod.loss`,
`hlod.backward` and `hlod.adam`; `hlod.lod_stream`
(render.render_lod_stream) around `hlod.cut`, `hlod.compact`,
`hlod.interp` and render_arrays' three; `hlod.post_step`
(pipeline/full_train.py's post_iteration) around `hlod.spt_cut` (the SPT
cut and the occlusion cull), render_params' three, `hlod.loss`,
`hlod.backward` and `hlod.adam` (train/post.py's
post_train_step) and, in a step with an MCMC round, `hlod.densify`
(densify_round) and `hlod.rebuild_spt` (rebuild_spt, which the set-up of
a post run opens too). A span records only while a profiler runs, so any
`torch.profiler.profile` over the program shows them; there is no
switch.

`counters` adds up, from process start, quantities the program already
holds on the host: render_lod_stream adds each frame's feedback as it
reads it, `lod.nodes_drawn` (the cut's nodes drawn) and
`lod.rows_interpolated` (the rows the frame's interpolation lerped: the
drawn rows alone on the masked path on a CUDA device, where the
lod_preprocess kernel runs it);
full_train.read_post_step adds each post step's feedback it reads,
`post.ws_rows` (the SPT cut's working-set rows) and
`post.rows_projected` (the rows the step's per-row work covered: the
state's capacity); optim.sparse_adam_cuda adds, at each launch of kernel
sparse_adam, `adam.rows_fused` (the rows it covered: the capacity);
ops/train_preprocess.py adds, at each launch of kernel
train_preprocess_forward, `project.rows_fused` (the rows it covered: the
capacity).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

from torch._C._profiler import _RecordFunctionFast

counters: collections.Counter = collections.Counter()


def span(name: str):
    """A context manager that records `name` over its block, on the calling
    thread, while a torch.profiler runs; about a microsecond otherwise.

    It is a host-side record (profiler scope FUNCTION, not USER_SCOPE as
    `torch.profiler.record_function` opens), so the profiler adds no
    device-side annotation for it and the device timeline keeps only
    kernels, copies and fills. Not for an autograd Function's backward,
    which the engine runs on another thread."""
    return _RecordFunctionFast(name)


class MetricsLogger:
    """Append-only JSONL metrics (one dict per event)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, **kv):
        kv.setdefault("ts", round(time.time(), 3))
        line = json.dumps(kv, default=float)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
