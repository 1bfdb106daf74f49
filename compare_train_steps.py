#!/usr/bin/env python3
"""Time one training stage's step of several checkouts of the port in turns,
on one CUDA card.

    python3 compare_train_steps.py [--arch 2d] [--rounds 3] [--steps 5] DIR [DIR ...]

Each DIR holds a checkout of this repository, for example
``git archive COMMIT | tar -x -C build/turns/COMMIT``, or ``.`` for this
one. Every round runs each checkout once, in the order given, in a process
of its own started in that checkout, through that checkout's own
``profile_train.make_state`` and ``step_times``: chip_smoke.py's training
configuration (full preset, bfloat16, global batch 8, remat, seeded random
weights, one synthetic batch already on the card), two warm-up steps, then
``--steps`` timed steps, each ending in ``torch.cuda.synchronize``. It
prints each turn's wall ms per step and host queueing ms, then per
checkout the median of each turn's median, every line with the card's name
and power limit. It raises without a card and catches nothing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import card_line

TURN = """
import json, sys, torch
from profile_train import make_state, step_times
state, cfg, batch = make_state(sys.argv[1])
step_times(state, cfg, batch, 2)
walls, queued = step_times(state, cfg, batch, int(sys.argv[2]))
print(json.dumps(dict(walls=walls, queued=queued, peak=torch.cuda.max_memory_allocated())))
"""


def turn(checkout: Path, arch: str, steps: int) -> dict:
    """One checkout's timed steps, from the last line of its process."""
    out = subprocess.run(
        [sys.executable, "-c", TURN, arch, str(steps)], cwd=checkout,
        capture_output=True, text=True, timeout=900,
    )
    if out.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", type=Path, help="checkouts, timed in this order each round")
    ap.add_argument("--arch", default="2d", choices=["2d", "3dpart", "end2end"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5, help="timed steps per turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_train_steps: torch.cuda.is_available() is false; this script needs a card")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}")
    medians: dict[Path, list[float]] = {d: [] for d in args.dirs}
    for r in range(args.rounds):
        for d in args.dirs:
            got = turn(d, args.arch, args.steps)
            medians[d].append(float(np.median(got["walls"])))
            print(f"round {r + 1} {d}: {args.arch} step wall ms {[round(w, 1) for w in got['walls']]}, "
                  f"host queueing ms {[round(q, 1) for q in got['queued']]}, "
                  f"peak {got['peak'] / 2**30:.2f} GiB [{card}]")
    for d, ms in medians.items():
        print(f"{d}: {args.arch} median ms/step per turn {[round(m, 1) for m in ms]}, "
              f"median {float(np.median(ms)):.1f} [{card}]")


if __name__ == "__main__":
    main()
