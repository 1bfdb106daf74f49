#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 hdu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name as a file of this folder:
``workloads/<cell>.json`` names its configuration (``configs/<name>.json``),
its traffic (``traffic/<name>.json``, whose ``runner`` names
``runners/<runner>.py`` and whose ``metric`` names the end-to-end metric
its runs report) and the limits of its correctness checks; every
``metrics/<metric>.py`` is a per-layer reader that a traced run asks for a
value. A cell, a configuration, a traffic mix or a metric is added by adding
its file.

The run needs as many CUDA cards as the cell asks for, and exits 3 without
a result otherwise. It exits 4 without a result when JAX or the JAX package
is loaded once the window has closed. ``--control 1`` puts the reference,
computed in float8, in the program's place, and ``--fault <name>`` plants a
fault in the program (``Run.apply_faults``): both serve only to set and to
test the checks' limits.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hdu_bench import harness  # noqa: E402

FAULTS = ("answer_altered", "half_batch", "state_unchanged")


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"hdu_bench: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(root: Path = HERE) -> dict:
    """{metric name: reader module} for every file in ``metrics/``."""
    return {p.name[: -len(".py")]: load_module(p, f"hdu_bench_metric_{i}")
            for i, p in enumerate(sorted((root / "metrics").glob("*.py")))}


class Run:
    """One run's settings and its shared objects, handed to the runner."""

    def __init__(self, cell: dict, cfg: dict, tr: dict, *, seed, seconds, trace, device,
                 control=False, fault=None, t_start=T_START, scratch=None):
        self.cell, self.cfg, self.traffic = cell, cfg, tr
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.chips = torch.device(device), int(cell.get("chips", 1))
        self.control, self.fault, self.t_start = control, fault, t_start
        self.spans = harness.Spans()
        self.checks = harness.Checks(cell["limits"])
        self.scratch = scratch
        self.undo: list = []  # (module, name, original) of every fault planted in a module

    @contextlib.contextmanager
    def reference_precision(self):
        """float32 with TF32 off, for the reference and the control; cuDNN
        picks its fastest algorithm for each of the reference's shapes."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.benchmark)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark) = saved

    def apply_faults(self, pred=None, state=None) -> None:
        """Plant ``self.fault`` in the program under test."""
        if self.fault is None:
            return
        if self.fault not in FAULTS:
            raise SystemExit(f"hdu_bench: unknown fault {self.fault!r}")
        if self.fault == "answer_altered" and pred is not None:
            collect, z = pred.collect, sum(self.traffic["liver_z"]) // 2

            def altered(handle):
                lab = collect(handle)
                lab[:, :, z] = (lab[:, :, z] + 1) % 3
                return lab

            pred.collect = altered
        elif self.fault == "half_batch" and pred is not None:
            from hdenseunet_tpu_torch.ops import score

            accumulate = score.window_accumulate

            def half(sc, count, logits, starts, weights, *, cols):
                w = np.array(weights, np.float32)
                w[len(w) // 2 :] = 0.0
                return accumulate(sc, count, logits, starts, w, cols=cols)

            half.launches = accumulate.launches  # the program counts its launches on the function
            self.undo.append((score, "window_accumulate", accumulate))
            score.window_accumulate = half
        elif self.fault == "half_batch" and state is not None:
            from hdenseunet_tpu_torch.train import trainer

            loss = trainer.weighted_crossentropy_2d

            def half(logits, labels, *a, **k):
                n = logits.shape[0] // 2
                return loss(logits[:n], labels[:n], *a, **k)

            self.undo.append((trainer, "weighted_crossentropy_2d", loss))
            trainer.weighted_crossentropy_2d = half
        elif self.fault == "state_unchanged" and state is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = 0.0
        else:
            raise SystemExit(f"hdu_bench: fault {self.fault!r} does not apply to this cell")


def execute(cell_name: str, cell: dict, cfg: dict, tr: dict, device, *, seed, seconds, trace,
            control=False, fault=None, t_start=T_START, root: Path = HERE) -> dict:
    """Run the cell once on ``device``; returns the result line's dict (the
    checks included, under their key) after printing it."""
    with tempfile.TemporaryDirectory() as scratch:
        h = Run(cell, cfg, tr, seed=seed, seconds=seconds, trace=trace, device=device,
                control=control, fault=fault, t_start=t_start, scratch=scratch)
        runner = load_module(root / "runners" / f"{tr['runner']}.py", f"hdu_bench_runner_{tr['runner']}")
        try:
            out = runner.run(h)
        finally:
            for mod, name, fn in h.undo:
                setattr(mod, name, fn)
    found = harness.forbidden_modules()
    if found:
        print(f"hdu_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(4)
    out["kind"] = tr["runner"]
    device_rec = dict(out["device"])
    metrics = {}
    if trace and "trace" in out:
        summary = out["trace"]
        device_rec.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        for name, reader in metric_readers(root).items():
            value = reader.read(out)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    elif not control:
        metrics = {k: {"value": v, "unit": out["units"][k]} for k, v in out["metrics"].items()}
    result = {
        "correct": h.checks.ok and out["failed"] == 0,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": device_rec,
    }
    if trace and "trace" in out:
        result["breakdown"] = {
            "device_ops": harness.top(out["trace"]["device_ops"]),
            "idle_gaps": harness.top(out["trace"]["idle_by_scope"]),
        }
    print(f"workload {cell_name} seed {seed}: card {harness.power_limit()}", file=sys.stderr)
    harness.emit(result, h.checks)
    return {**result, "checks": h.checks.record()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    args = ap.parse_args(argv)
    cell = load_json("workloads", args.workload)
    cfg = load_json("configs", cell["config"])
    tr = load_json("traffic", cell["traffic"])
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hdu_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    execute(args.workload, cell, cfg, tr, torch.device("cuda", 0), seed=args.seed,
            seconds=args.seconds, trace=args.trace, control=bool(args.control), fault=args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
