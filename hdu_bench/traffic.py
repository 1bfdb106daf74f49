"""The one generator of the benchmark's inputs, driven by a traffic file's
parameters and the run's seed. The program receives only what it makes.

Serving (``serve_pool``): a pool of CT volumes, each ``normal(0,
intensity_sd)`` (bench.py's synthetic volume) rounded to whole HU and
clipped to the HU window as the prepared LiTS volumes are, in float32
(whole HU minus the mean are exact in bfloat16), with an external
liver mask that is 1 over the box ``xy_margin`` in from each side and over
slices [liver_z[0], liver_z[1]); volume i of the pool draws from (seed, i)
on the device's generator.

Training (``train_pool``): a pool of batches of crops of the
configuration's batch and size, x 3 channels, ``normal(0, intensity_sd)``, with per-pixel labels drawn uniformly
from the classes (bench.py's synthetic batches), made on the device.

Training from prepared volumes (``prepared_dataset``): the prepared
directory layout the program's sampler reads (``volumes/volume-i.npy``
HU-clipped float32, ``segmentations/segmentation-i.npy`` int16,
``coords/coords-i.npz`` with the liver and tumour voxel coordinates and the
liver's bounding box), for ``volumes`` volumes of ``shape``: an ellipsoid
liver (label 1, normal(80, 15) HU) around the centre with a spherical
tumour (label 2, normal(160, 10) HU) inside it, on a normal(-100, 30)
background, clipped to [-200, 250].
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _gen(device, seed: int, *salt: int) -> torch.Generator:
    mixed = np.random.SeedSequence([int(seed), *salt]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) << 32 | int(mixed[1]))


def serve_pool(params: dict, seed: int, device) -> list:
    """[(volume (X, Y, Z) float32, external mask (X, Y, Z) uint8)] x pool."""
    x, y, z = params["shape"]
    m = params["xy_margin"]
    z0, z1 = params["liver_z"]
    out = []
    for i in range(params["pool"]):
        vol = torch.randn((x, y, z), generator=_gen(device, seed, 1, i), device=device)
        vol = (vol * params["intensity_sd"]).round_().clamp_(*params["hu_window"]).cpu().numpy()
        mask = np.zeros((x, y, z), np.uint8)
        mask[m : x - m, m : y - m, z0:z1] = 1
        out.append((vol, mask))
    return out


def train_pool(params: dict, b: int, s: int, seed: int, device, num_classes: int) -> list:
    """[{"image": (b, s, s, 3) float32, "label": (b, s, s) int32}] x pool,
    on ``device``; every row differs."""
    n = params["pool"]
    gen = _gen(device, seed, 2)
    images = torch.randn((n, b, s, s, 3), generator=gen, device=device) * params["intensity_sd"]
    labels = torch.randint(0, num_classes, (n, b, s, s), generator=gen, device=device,
                           dtype=torch.int32)
    return [{"image": images[i], "label": labels[i]} for i in range(n)]


def prepared_dataset(params: dict, seed: int, out_dir) -> None:
    """Write the prepared dataset (module docstring) into ``out_dir``."""
    out = Path(out_dir)
    for sub in ("volumes", "segmentations", "coords"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    shape = np.asarray(params["shape"])
    x, y, z = np.ogrid[: shape[0], : shape[1], : shape[2]]
    for i in range(params["volumes"]):
        rng = np.random.default_rng([int(seed), 3, i])
        c = shape // 2 + rng.integers(-4, 5, 3)
        r = shape * 0.3
        liver = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((z - c[2]) / r[2]) ** 2 < 1
        tc = c + rng.integers(-3, 4, 3)
        tr = max(2.0, float(shape.min()) * 0.08)
        tumour = ((x - tc[0]) ** 2 + (y - tc[1]) ** 2 + (z - tc[2]) ** 2) < tr**2
        seg = np.zeros(tuple(shape), np.int16)
        seg[liver] = 1
        seg[tumour & liver] = 2
        vol = rng.normal(-100.0, 30.0, tuple(shape)).astype(np.float32)
        vol[seg == 1] = rng.normal(80.0, 15.0, int((seg == 1).sum()))
        vol[seg == 2] = rng.normal(160.0, 10.0, int((seg == 2).sum()))
        np.save(out / "volumes" / f"volume-{i}.npy", np.clip(vol, -200.0, 250.0))
        np.save(out / "segmentations" / f"segmentation-{i}.npy", seg)
        lv, tm = np.argwhere(seg == 1).astype(np.int32), np.argwhere(seg == 2).astype(np.int32)
        np.savez(out / "coords" / f"coords-{i}.npz", liver=lv, tumor=tm,
                 box_min=lv.min(axis=0).astype(np.int32), box_max=lv.max(axis=0).astype(np.int32))
