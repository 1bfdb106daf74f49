#!/usr/bin/env python3
"""Time the K4 labelling kernels of several checkouts of the port in turns,
on one CUDA card.

    python3 compare_cc.py [--rounds 2] DIR [DIR ...]

Each DIR holds a checkout of this repository, for example
``git archive COMMIT | tar -x -C build/turns/COMMIT``, or ``.`` for this
one. Every round runs each checkout once, in the order given, in a process
of its own started in that checkout, which builds that checkout's kernels
and times, through its own ``chip_smoke.cuda_ms`` and ``cold_ms`` (warm,
and with the L2 flushed), ``cc_label``, ``largest_component`` and
``fill_holes`` at 512x512x112 on chip_smoke.py's ellipsoid case (the
compose's own inputs, from ``compose_prep``) and on seeded random masks at
p = 0.05 and 0.3, ``compose_finish`` on the ellipsoid's liver and tumour,
and the whole ``compose_final``. It prints each turn's
times and per checkout the median of each time over the rounds, every line
with the card's name and power limit. It raises without a card and catches
nothing.
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
import json, numpy as np, torch
import chip_smoke as S
from hdenseunet_tpu_torch.infer import device_postprocess as D
from hdenseunet_tpu_torch.ops import cc
liver, tumor, ext = S.ellipsoid_case(S.K4_SHAPE)
packed, ext_bits = S.compose_inputs(liver, tumor, ext, S.K4_SHAPE[2])
l_in, t_in, e_in = cc.compose_prep(packed, ext_bits, pack_z=S.K4_SHAPE[2])
rng = np.random.default_rng(0)
cases = {"ellipsoid": (l_in, e_in)}
for p in (0.05, 0.3):
    m = torch.from_numpy(rng.random(S.K4_SHAPE) < p).cuda()
    cases[f"p={p}"] = (m, m)
out = {}
for case, (a, b) in cases.items():
    for name, fn in (("cc_label", lambda: cc.cc_label(a)), ("largest_component", lambda: cc.largest_component(a)),
                     ("fill_holes", lambda: cc.fill_holes(b))):
        out[f"{name} {case}"] = S.cuda_ms(fn, iters=20)
        out[f"{name} {case} L2 flushed"] = S.cold_ms(fn)
finish = lambda: cc.compose_finish(l_in, t_in)
out["compose_finish ellipsoid"] = S.cuda_ms(finish, iters=20)
out["compose_finish ellipsoid L2 flushed"] = S.cold_ms(finish)
out["compose_final ellipsoid"] = S.cuda_ms(lambda: D.compose_final(packed, ext_bits, pack_z=S.K4_SHAPE[2]), iters=5)
print(json.dumps(out))
"""


def turn(checkout: Path, code: str = TURN) -> dict:
    """One checkout's times, from the last line of ``code`` run in a
    process of its own in the checkout."""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=checkout, capture_output=True, text=True, timeout=900,
    )
    if out.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(code: str = TURN, doc: str = __doc__) -> None:
    """Time ``code`` (a turn's program, which prints one JSON object of ms
    last) in every checkout of the command line, in turns."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("dirs", nargs="+", type=Path, help="checkouts, timed in this order each round")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(f"{ap.prog}: torch.cuda.is_available() is false; this script needs a card")
    card = card_line()
    times: dict[Path, list[dict]] = {d: [] for d in args.dirs}
    for r in range(args.rounds):
        for d in args.dirs:
            times[d].append(turn(d, code))
            print(f"round {r} {d}: " + ", ".join(f"{k} {v:.4f}" for k, v in times[d][-1].items())
                  + f" ms [{card}]", flush=True)
    for d, runs in times.items():
        print(f"median {d}: " + ", ".join(f"{k} {np.median([t[k] for t in runs]):.4f}" for k in runs[0])
              + f" ms over {len(runs)} turns [{card}]")


if __name__ == "__main__":
    main()
