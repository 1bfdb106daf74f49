#!/usr/bin/env python3
"""What the real data feed costs the PyTorch port's train step, on one card.

    python3 profile_feed.py [--steps 6] [--pairs 2]

Prepares two synthetic 512x512x64 volumes (``preprocess.synthesize``) in a
temporary directory under build/, which it removes, and prints one line per
measurement, each with the card's name and power limit:

1. the CropSampler alone (batch 8, 224x224x8 sub-volumes): samples/s at 1,
   2, 4 and 8 crop threads, as shipped (each volume memory-mapped once per
   sampler) and with the volumes opened anew for every sample, as the JAX
   package's sampler does (a subclass here; the package has no switch);
2. the end2end train step (chip_smoke.py's configuration: full preset,
   bfloat16, batch 8, remat; a loss sync after every step, as
   ``log_every_steps=1`` does) fed five ways, in turns: synthetic batches
   drawn before the turn; real crops drawn before the turn (the same work
   on the card, no cropping beside it); and the CLI's live feed
   (``input_pipeline``: CropSampler threads, the host prefetch thread,
   pinned copies on a side stream) at 8 and at 2 crop threads, and at 8
   with the volumes opened per sample. ms/step is the wall from one step's start
   to the next one's, the first step of each turn left out.

It raises without a card and catches nothing.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import BUILD, SEED, card_line


def sampler(prep: Path, mapped_once: bool, seed: int = SEED):
    """The hybrid CropSampler as shipped, or one that opens the volumes
    anew for every sample (the same bytes)."""
    from hdenseunet_tpu_torch.data.preprocess import PreparedDataset
    from hdenseunet_tpu_torch.data.sampler import CropSampler

    class OpenPerSample(CropSampler):
        def _arrays(self, i):
            return self.ds.volume(i), self.ds.segmentation(i)

    return (CropSampler if mapped_once else OpenPerSample)(PreparedDataset(prep), mode="hybrid", seed=seed)


def sampler_rate(prep: Path, threads: int, mapped_once: bool, batches: int = 8) -> float:
    gen = sampler(prep, mapped_once).batches(8, threads=threads)
    next(gen)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(gen)
    rate = 8 * batches / (time.perf_counter() - t0)
    gen.close()
    return rate


def run_turn(state, cfg, feed, steps: int) -> list[float]:
    """ms from each step's start to the next one's, steps 2..steps."""
    from hdenseunet_tpu_torch.train.trainer import train_step

    starts = []
    for _ in range(steps + 1):
        starts.append(time.perf_counter())
        if len(starts) > steps:
            break
        float(train_step(state, next(feed), cfg))
    return [(b - a) * 1e3 for a, b in zip(starts[1:], starts[2:])]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6, help="steps per turn")
    ap.add_argument("--pairs", type=int, default=2, help="rounds of the five feeds, forth and back")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_feed: torch.cuda.is_available() is false; this script needs a card")
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.data import preprocess
    from hdenseunet_tpu_torch.data.pipeline import input_pipeline
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.train.trainer import create_train_state

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}; "
          f"{os.cpu_count()} host cores")
    BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="profile_feed_", dir=BUILD))
    try:
        prep = preprocess.synthesize(root / "prep", num_volumes=2, shape=(512, 512, 64), seed=SEED)
        for mapped_once in (False, True):
            rates = {t: sampler_rate(prep, t, mapped_once) for t in (1, 2, 4, 8)}
            print(f"CropSampler alone, hybrid 224x224x8, batch 8, volumes "
                  f"{'mapped once' if mapped_once else 'opened per sample'}: samples/s by crop threads "
                  + ", ".join(f"{t}: {r:.1f}" for t, r in rates.items()) + f" [{card}]")

        cfg = Config()
        cfg.model.compute_dtype = "bfloat16"
        cfg.train.arch, cfg.train.batch = "end2end", 8
        state = create_train_state(cfg, device="cuda", seed=SEED)
        n = args.steps + 1
        synth = synthetic_batches(mode="hybrid", batch=8, seed=SEED)
        synthetic = [next(synth) for _ in range(n)]
        real_gen = sampler(prep, True, seed=SEED + 1).batches(8, threads=8)
        real = [next(real_gen) for _ in range(n)]
        real_gen.close()

        def live(threads, mapped_once):
            feed, host = input_pipeline(sampler(prep, mapped_once), 8, "cuda", threads=threads)
            return feed, host

        feeds = {
            "synthetic, drawn before": lambda: (iter(synthetic), None),
            "real crops, drawn before": lambda: (iter(real), None),
            "live pipeline, 8 crop threads": lambda: live(8, True),
            "live pipeline, 2 crop threads": lambda: live(2, True),
            "live pipeline, 8 crop threads, volumes opened per sample": lambda: live(8, False),
        }
        run_turn(state, cfg, iter(synthetic), 2)  # warm-up: cuDNN's first calls
        times = {name: [] for name in feeds}
        order = list(feeds)
        for _ in range(args.pairs):
            for name in order + order[::-1]:
                feed, host = feeds[name]()
                try:
                    times[name] += run_turn(state, cfg, feed, args.steps)
                finally:
                    if host is not None:
                        host.close()
        for name, ms in times.items():
            print(f"end2end step, {name}: median {float(np.median(ms)):.1f} ms/step, quartiles "
                  f"{float(np.percentile(ms, 25)):.1f}-{float(np.percentile(ms, 75)):.1f} over "
                  f"{len(ms)} steps [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
