#!/usr/bin/env python3
"""Finds the op that makes two runs of the port on identical inputs differ,
on one GPU, in PyTorch's default (non-deterministic) mode.

    python3 scripts/torch_determinism_probe.py [--what train pipeline
                                                pipeline-plain]
                                                [--iters C K P]
                                                [--out chiprun_out/x.json]

Each run is recorded op by op through a TorchDispatchMode: every aten op's
name, the innermost source line of hlod_gaussians_torch that issued it, and
a position-weighted checksum of the bits of its tensor inputs and of its
outputs (outputs of the `empty*` allocators, whose bits are whatever the
allocator held, are not summed). The two runs' records are then walked in
order: the first op whose inputs are bitwise equal in both runs but whose
outputs are not names the nondeterministic op; an op whose inputs already
differ while every earlier output matched received data that no aten op
wrote (a hand-written kernel or a copy from the host).

- `train`: one train.flat.train_step at chip_smoke.py phase [5]'s point
  (the 100k-Gaussian bench scene at 1920x1080, SH 3), twice from the same
  state.
- `pipeline`: run_pipeline at chip_smoke.py phase [18]'s point (PIPE_MP:
  4 shells x 250,000 points, 512x512, 20 / 30 / 10 steps, or the coarse /
  chunk / post steps of --iters) twice on one scene, each into its own
  directory; then the merged.dhier bytes and every chunk's artifacts
  compared. `pipeline-plain` does the same without the recorder.
- `sampler`: the MCMC host sampler mcmc.sample_hosts against the
  torch.multinomial it replaced, at the post bench capacity (2^22 rows,
  8,192 draws) and at the pipeline chunk capacity (2^19 rows, 4,096):
  each twice from one seed (repeatable or not) and timed with CUDA events.
- `gmsd`: ops/perceptual.gmsd of a seeded 1920x1080 pair on the card,
  under PyTorch's default cuDNN flags (TF32 allowed) and with TF32 off,
  against the CPU.

Prints the first differences of each and writes them as JSON to --out.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_UNSUMMED = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "resize_", "set_", "record_stream")


def _recorder_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    int_of_size = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}
    pkg = os.path.join(ROOT, "hlod_gaussians_torch")

    class OpRecorder(TorchDispatchMode):
        """name, source line and (input, output) checksums of every aten op
        run while the mode is active."""

        def __init__(self):
            super().__init__()
            self.names, self.where, self.sums, self._pending = [], [], [], []
            self._weights = {}
            self._device = torch.device(
                "cuda" if torch.cuda.is_available() else "cpu")
            self._zero = torch.zeros((), dtype=torch.int64,
                                     device=self._device)

        def _weight(self, n, device):
            w = self._weights.get(device)
            if w is None or w.shape[0] < n:
                w = torch.arange(max(n, 1 << 20), dtype=torch.int64,
                                 device=device) % 65521 + 1
                self._weights[device] = w
            return w[:n]

        def _checksum(self, leaves):
            total = None
            for j, t in enumerate(leaves):
                if (not isinstance(t, torch.Tensor)
                        or t.layout != torch.strided or t.is_complex()
                        or t.numel() == 0):
                    continue
                x = t.detach().contiguous().reshape(-1)
                x = x.view(int_of_size[x.element_size()]).to(torch.int64)
                s = (x * self._weight(x.shape[0], x.device)).sum() * (j + 1)
                s = s.to(self._device)
                total = s if total is None else total + s
            return total if total is not None else self._zero

        def _source(self):
            f = sys._getframe(2)
            while f is not None:
                if f.f_code.co_filename.startswith(pkg):
                    return (f"{os.path.relpath(f.f_code.co_filename, ROOT)}:"
                            f"{f.f_lineno}")
                f = f.f_back
            return "?"

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = tree_flatten((args, kwargs))[0]
            in_sum = self._checksum(ins)
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            out_sum = (self._zero if name in _UNSUMMED
                       else self._checksum(tree_flatten(out)[0]))
            self.names.append(str(func))
            self.where.append(self._source())
            self._pending.append(torch.stack([in_sum, out_sum]))
            if len(self._pending) >= 4096:
                self._flush()
            return out

        def _flush(self):
            if self._pending:
                self.sums.append(torch.stack(self._pending).cpu().numpy())
                self._pending = []

        def result(self):
            self._flush()
            sums = (np.concatenate(self.sums) if self.sums
                    else np.zeros((0, 2), np.int64))
            return self.names, self.where, sums

    return OpRecorder


def first_differences(a, b, limit=12):
    """The first `limit` ops where two records part: ("nondeterministic",
    both inputs equal, outputs not), ("input", inputs and outputs differ
    while every earlier output matched) or ("diverged", the op sequence
    itself)."""
    (na, wa, sa), (nb, wb, sb) = a, b
    found, clean = [], True
    for i in range(min(len(na), len(nb))):
        if na[i] != nb[i]:
            found.append(dict(index=i, kind="diverged", op=na[i],
                              other=nb[i], where=wa[i]))
            break
        in_eq, out_eq = sa[i, 0] == sb[i, 0], sa[i, 1] == sb[i, 1]
        if in_eq and not out_eq:
            found.append(dict(index=i, kind="nondeterministic", op=na[i],
                              where=wa[i]))
        elif not in_eq and not out_eq and clean:
            found.append(dict(index=i, kind="input", op=na[i], where=wa[i]))
        if not out_eq:
            clean = False
        if len(found) >= limit:
            break
    return dict(ops=(len(na), len(nb)), first=found)


def recorded(fn):
    import torch
    rec = _recorder_class()()
    t0 = time.perf_counter()
    with rec:
        out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, rec.result(), time.perf_counter() - t0


def probe_train(dev):
    import torch
    import chip_smoke as cs
    from hlod_gaussians_torch.config import OptimizationConfig
    from hlod_gaussians_torch.train import flat
    ts0, _, gts = cs.dp_inputs(dev, (0.0,), cs.load_bench_scene())
    cam = cs.bench_view(0.0, dev)
    kw = dict(exposure_idx=0, scene_extent=8.0, opt=OptimizationConfig(),
              cfg=cs.bench_cfg(), width=cs.FRAME[0], height=cs.FRAME[1],
              sh_degree=3)

    def step():
        return flat.train_step(ts0, cam.world_view, cam.full_proj,
                               cam.campos, cam.tan_fovx, cam.tan_fovy,
                               gts[0], torch.zeros(3, device=dev), **kw)

    (ts_a, _), rec_a, sec_a = recorded(step)
    (ts_b, _), rec_b, sec_b = recorded(step)
    diff = first_differences(rec_a, rec_b)
    equal = {k: bool(torch.equal(v, ts_b.gaussians.params()[k]))
             for k, v in ts_a.gaussians.params().items()}
    equal.update({f"adam.m.{k}": bool(torch.equal(v, ts_b.adam.m[k]))
                  for k, v in ts_a.adam.m.items()})
    return dict(diff, seconds=(sec_a, sec_b), state_equal=equal)


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def probe_pipeline(dev, record=True, iters=None):
    import torch
    import chip_smoke as cs
    from hlod_gaussians_torch.pipeline import full_train
    scene, (pcfg, opt, pconf, mcfg, cfg) = cs.pipeline_mp_inputs(dev)
    if iters:
        pcfg, opt, pconf, mcfg, cfg = cs.pipeline_settings(
            *iters, cs.PIPE_MP["post_densify"])
    runs = []
    with tempfile.TemporaryDirectory(prefix="detprobe_") as root:
        for r in range(2):
            out = os.path.join(root, f"run{r}")

            def run():
                return full_train.run_pipeline(
                    scene, view_loader=lambda ci: ci.v, output_dir=out,
                    pcfg=pcfg, opt=opt, post=pconf, cfg=cfg, mcfg=mcfg,
                    device=dev)
            if record:
                merged, rec, sec = recorded(run)
            else:
                t0 = time.perf_counter()
                merged, rec = run(), None
                torch.cuda.synchronize() if dev.type == "cuda" else None
                sec = time.perf_counter() - t0
            runs.append((len(merged.nodes), rec, sec, _tree_files(out)))
            print(f"  run {r}: {runs[-1][0]} merged nodes in {sec:.1f} s",
                  flush=True)
        files_a, files_b = runs[0][3], runs[1][3]
        differing = sorted(k for k in files_a
                           if files_a[k] != files_b.get(k))
    res = dict(nodes=[r[0] for r in runs], seconds=[r[2] for r in runs],
               differing_files=differing)
    if record:
        res.update(first_differences(runs[0][1], runs[1][1]))
    return res


def probe_sampler(dev):
    import torch
    from hlod_gaussians_torch.hierarchy import mcmc

    def old(probs, k, gen):
        return torch.multinomial(probs, k, replacement=True, generator=gen)
    res = {}
    for rows, k in ((1 << 22, 8192), (1 << 19, 4096)):
        probs = torch.rand((rows,), generator=torch.Generator(
            device=dev).manual_seed(3), device=dev) ** 4
        for name, fn in (("multinomial", old), ("sample_hosts",
                                                mcmc.sample_hosts)):
            draws = [fn(probs, k, torch.Generator(device=dev).manual_seed(0))
                     for _ in range(2)]
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            a.record()
            for _ in range(20):
                fn(probs, k, torch.Generator(device=dev).manual_seed(0))
            b.record()
            b.synchronize()
            res[f"{name} {rows} rows {k} draws"] = dict(
                repeatable=bool(torch.equal(draws[0], draws[1])),
                ms=a.elapsed_time(b) / 20)
    return res


def probe_gmsd(dev):
    import torch
    from hlod_gaussians_torch.ops.perceptual import gmsd
    rng = np.random.default_rng(3)
    a = rng.random((3, 1080, 1920)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.05, 0, 1)
    cpu = float(gmsd(torch.as_tensor(a), torch.as_tensor(b)))
    cudnn = torch.backends.cudnn
    res = dict(cpu=cpu)
    for tf32 in (True, False):
        with cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                         allow_tf32=tf32):
            card = float(gmsd(torch.as_tensor(a, device=dev),
                              torch.as_tensor(b, device=dev)))
        res[f"allow_tf32={tf32}"] = dict(card=card, abs_diff=abs(card - cpu))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", nargs="+", default=["train", "pipeline"],
                    choices=["train", "pipeline", "pipeline-plain",
                             "sampler", "gmsd"])
    ap.add_argument("--iters", nargs=3, type=int, default=None,
                    help="coarse, chunk and post steps of the recorded "
                    "pipeline (default PIPE_MP's)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "determinism_probe.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_determinism_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()}, cudnn "
          f"deterministic {torch.backends.cudnn.deterministic}", flush=True)
    report = dict(device=smi)
    for what in args.what:
        t0 = time.perf_counter()
        if what == "train":
            res = probe_train(dev)
        elif what == "sampler":
            res = probe_sampler(dev)
        elif what == "gmsd":
            res = probe_gmsd(dev)
        else:
            rec = what == "pipeline"
            res = probe_pipeline(dev, record=rec,
                                 iters=args.iters if rec else None)
        res["wall_s"] = time.perf_counter() - t0
        report[what] = res
        print(f"[{what}] " + json.dumps(res, indent=1), flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
