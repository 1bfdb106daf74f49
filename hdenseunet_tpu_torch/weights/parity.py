"""Block-level activation parity harness (counterpart of
hdenseunet_tpu/weights/parity.py): converted weights against a reference.

* ``dump``: run the model on a fixed input in float32 and record the
  activation at every encoder stage boundary (relu1 and each dense block's
  output, the reference graph's ``box`` taps, densenet.py:60/:189), the
  decoder feature map and the logits, into an npz; the legacy
  skip-connection 2D decoder (also its 'line0' projection), the 3D branch,
  the hybrid's fusion boundary and the dilated residual network's logits
  likewise;
* ``compare``: diff two dumps tensor by tensor, with the max and mean
  absolute error of each and a pass/fail verdict.

Taps are named and shaped as in the JAX package and in Keras, channels last:
(B, H, W, C) and (B, H, W, D, C). A dump of this package, of the JAX package
and of the reference's Keras graph on the same ``.npz`` weights and
``parity_input.npy`` are comparable two by two. A layer the ``.npz`` lacks
keeps each package's own initialisation, so a comparison across packages
needs an ``.npz`` that covers every layer. The Keras side waits for the
released ``.h5`` weights (the JAX module's docstring gives its script).

    python -m hdenseunet_tpu_torch.weights.parity dump --weights conv.npz --out torch_acts.npz
    python -m hdenseunet_tpu_torch.weights.parity compare torch_acts.npz reference_acts.npz

``dump`` runs on the card unless ``--device cpu``; on the card TF32 is off
for the dump, so it is float32 arithmetic throughout.
"""
from __future__ import annotations

import argparse
import contextlib
from pathlib import Path

import numpy as np
import torch

# names matching the reference graph's tap layers, in encoder order
TAPS = ("relu1", "concat_2_6", "concat_3_12", "concat_4_36", "relu5_blk")


@contextlib.contextmanager
def _float32_arithmetic():
    """TF32 off in cuDNN and cuBLAS for the block, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _run(model, params, bn_state, x, device, **kwargs) -> dict:
    """Load (params, bn_state) (JAX layout) into model, run it on device in
    float32 with taps, return {tap: float32 numpy array}."""
    from ..core import params as P

    model = P.from_numpy(model, params, bn_state).to(device).eval()
    taps: dict = {}
    with torch.inference_mode(), _float32_arithmetic():
        model(torch.as_tensor(np.asarray(x, np.float32), device=device), taps=taps, **kwargs)
        return {name: t.float().cpu().numpy() for name, t in taps.items()}


def dump_activations(
    params, bn_state, x, *, reduction=0.5, preset="full", skip_connections=False, device="cuda"
):
    """Run DenseUNet-2D and return {tap_name: activation} including decoder
    feature map ('ac_up4') and logits ('dense167classifer'); with
    ``skip_connections`` the legacy decoder, whose 'line0' is tapped too."""
    from ..models import denseunet2d

    model = denseunet2d.DenseUNet2D(
        reduction=reduction, skip_connections=skip_connections, **denseunet2d.PRESETS[preset]
    )
    return _run(model, params, bn_state, x, device)


def dump_activations_3d(params, bn_state, x, *, preset="full", device="cuda"):
    """3D-branch taps: per-dense-block concats, final relu, '3dac_up4'
    features, '3dclassifer' logits (reference denseunet3d.py graph names)."""
    from ..models import denseunet3d

    model = denseunet3d.DenseUNet3D(in_channels=int(np.shape(x)[-1]), **denseunet3d.PRESETS[preset])
    return _run(model, params, bn_state, x, device)


def dump_activations_hybrid(params, bn_state, vol, *, arch="end2end", preset="full", device="cuda"):
    """Hybrid fusion-boundary taps: res2d/fea2d (z-stacked 2D outputs),
    feat3d, and the '2d3dclassifer' logits (reference hybridnet.py:409-419)."""
    from ..models.hybrid import HDenseUNet

    return _run(HDenseUNet(preset=preset), params, bn_state, vol, device, arch=arch)


def dump_activations_dilated(params, bn_state, x, *, device="cuda"):
    """The dilated residual network's logits ('dr_head', its one stable tap:
    the reference leaves every layer auto-named), at the widths of params."""
    from ..models.dilated_resnet import DilatedResNet

    widths = tuple(int(np.shape(params[f"{name}_c1" if name != "dr_stem" else name]["bias"])[0])
                   for name in ("dr_stem", "dr_res1", "dr_res2", "dr_res3"))
    model = DilatedResNet(in_channels=int(np.shape(x)[-1]), widths=widths)
    return _run(model, params, bn_state, x, device)


def compare_dumps(a_path, b_path, *, rtol=1e-3, atol=1e-3, log=print) -> bool:
    ok = True
    with np.load(a_path) as a, np.load(b_path) as b:
        keys = sorted(set(a.files) & set(b.files))
        missing = sorted(set(a.files) ^ set(b.files))
        if missing:
            log(f"WARNING: tensors only on one side: {missing}")
        for k in keys:
            x, y = a[k], b[k]
            if x.shape != y.shape:
                log(f"FAIL {k}: shape {x.shape} vs {y.shape}")
                ok = False
                continue
            err = np.abs(x.astype(np.float64) - y.astype(np.float64))
            scale = np.maximum(np.abs(y).max(), 1e-9)
            passed = err.max() <= atol + rtol * scale
            ok &= passed
            log(
                f"{'PASS' if passed else 'FAIL'} {k}: max {err.max():.3e} "
                f"mean {err.mean():.3e} (|ref|max {scale:.3e})"
            )
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(prog="parity", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump")
    d.add_argument("--weights", required=True, help="converted .npz checkpoint")
    d.add_argument("--out", required=True)
    d.add_argument("--input", default=None, help="npy input; random if absent")
    d.add_argument("--input-size", type=int, default=224)
    d.add_argument("--model", choices=["2d", "3d", "hybrid"], default="2d")
    d.add_argument("--arch", choices=["end2end", "3dpart"], default="end2end")
    d.add_argument("--input-cols", type=int, default=8)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--rtol", type=float, default=1e-3)
    c.add_argument("--atol", type=float, default=1e-3)

    args = ap.parse_args(argv)
    if args.cmd == "compare":
        ok = compare_dumps(args.a, args.b, rtol=args.rtol, atol=args.atol)
        raise SystemExit(0 if ok else 1)

    from ..core import params as P
    from ..core.initializers import init_model
    from ..models import denseunet2d, denseunet3d
    from ..models.hybrid import HDenseUNet
    from .convert import load_npz_checkpoint, match_to_model

    size, cols = args.input_size, args.input_cols
    if args.model == "2d":
        model = denseunet2d.DenseUNet2D(**denseunet2d.PRESETS["full"])
        in_shape = (1, size, size, 3)
    elif args.model == "3d":
        model = denseunet3d.DenseUNet3D(in_channels=4, **denseunet3d.PRESETS["full"])
        in_shape = (1, size, size, cols, 4)
    else:
        model = HDenseUNet(preset="full")
        in_shape = (1, size, size, cols, 1)
    init_model(model, 0)  # layers the .npz lacks keep this initialisation
    report = match_to_model(load_npz_checkpoint(args.weights), model, strict_shapes=False)
    print(f"loaded {len(report['loaded'])} layers, skipped {len(report['skipped'])}")
    params, bn_state = P.to_numpy(model)

    if args.input:
        x = np.load(args.input)
    else:
        x = np.random.default_rng(args.seed).normal(0, 60, in_shape).astype(np.float32)
        np.save(Path(args.out).with_name("parity_input.npy"), x)
    if args.model == "2d":
        acts = dump_activations(params, bn_state, x, device=args.device)
    elif args.model == "3d":
        acts = dump_activations_3d(params, bn_state, x, device=args.device)
    else:
        acts = dump_activations_hybrid(params, bn_state, x, arch=args.arch, device=args.device)
    np.savez_compressed(args.out, **acts)
    print(f"wrote {args.out}: {sorted(acts)}")


if __name__ == "__main__":
    main()
