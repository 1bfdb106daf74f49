"""Command line of the port (counterpart of hdenseunet_tpu/cli.py).

    python -m hdenseunet_tpu_torch synth-data --out prep --num-volumes 2 --shape 512,512,64
    python -m hdenseunet_tpu_torch preprocess --raw data/TrainingData --out data/prepared
    python -m hdenseunet_tpu_torch train --arch 2d --data prep --checkpoint-dir ck2d
    python -m hdenseunet_tpu_torch train --arch end2end --data prep --init-from ck2d --checkpoint-dir cke
    python -m hdenseunet_tpu_torch train --arch end2end --data prep --checkpoint-dir cke --resume
    torchrun --nproc_per_node 8 -m hdenseunet_tpu_torch train --arch end2end --data prep --batch 8
    python -m hdenseunet_tpu_torch test --data tv --livermask tm --weights cke --save-path res
    python -m hdenseunet_tpu_torch test --data tv --livermask tm --weights cke --tiled 256
    python -m hdenseunet_tpu_torch evaluate --pred res --truth truth --num-volumes 1
    python -m hdenseunet_tpu_torch convert-weights model.h5 weights.npz [--submodel denseu161]
    python -m hdenseunet_tpu_torch export-weights cke model.h5 --arch end2end

The flags are the JAX CLI's, with ``--set section.key value`` overrides of
the typed Config, plus ``--device`` (``cuda`` unless asked otherwise) on
``train``, ``test`` and ``export-weights``. ``train`` joins a torchrun
environment, one process per card: ``--batch`` stays the global batch, each
process feeds its share and trains on its card (``cuda:LOCAL_RANK``), and
only rank 0 prints. ``--init-from`` and
``--weights`` take a port checkpoint directory or an ``.npz`` of
'{layer}/{leaf}' arrays, which ``convert-weights`` writes from a Keras HDF5
file. ``convert-weights`` and ``export-weights`` need h5py; without it they
exit, and the ``.npz`` made where h5py is installed is the way in.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _load_config(path, overrides):
    from .core.config import Config

    cfg = Config.load(path) if path else Config()
    for key, value in overrides.items():
        section, name = key.split(".", 1)
        obj = getattr(cfg, section)
        if not hasattr(obj, name):
            raise SystemExit(f"unknown config key {key}")
        current = getattr(obj, name)
        if isinstance(current, str):
            parsed = value
        else:
            try:
                parsed = json.loads(value)  # int/float/bool/null/lists
            except (ValueError, TypeError):
                parsed = value
        setattr(obj, name, tuple(parsed) if isinstance(parsed, list) else parsed)
    return cfg


def cmd_preprocess(args):
    from .core.config import DataConfig
    from .data import preprocess

    preprocess.run(
        args.raw, args.out, num_volumes=args.num_volumes,
        with_seg=not args.no_seg, cfg=DataConfig(),
    )


def cmd_synth_data(args):
    from .data import preprocess

    shape = tuple(int(s) for s in args.shape.split(","))
    preprocess.synthesize(
        args.out, num_volumes=args.num_volumes, shape=shape, seed=args.seed, log=print
    )
    print(f"synthetic dataset at {args.out}")


def cmd_train(args):
    """Train one stage; returns the final TrainState."""
    from .core.mesh import make_mesh
    from .data.pipeline import input_pipeline
    from .data.preprocess import PreparedDataset
    from .data.sampler import CropSampler, synthetic_batches
    from .parallel import multihost
    from .train import trainer
    from .weights import convert as wconv

    # no-op unless a multi-process environment (torchrun) is configured
    multihost.initialize(backend="gloo" if args.device == "cpu" else None)
    device = multihost.local_device() if args.device == "cuda" else args.device
    cfg = _load_config(args.config, dict(args.set or []))
    cfg.train.arch = args.arch
    if args.batch:
        cfg.train.batch = args.batch
    mode = "2d" if args.arch == "2d" else "hybrid"
    # each process samples only its rows of the global batch, with a
    # process-disjoint random stream
    feed_batch = multihost.local_batch_size(cfg.train.batch)
    feed_seed = cfg.train.seed + multihost.process_index()
    log = print if multihost.is_primary() else (lambda *_a, **_k: None)

    host = None
    if args.data:
        sampler = CropSampler(
            PreparedDataset(args.data),
            cfg.data,
            mode=mode,
            input_size=cfg.model.input_size,
            input_cols=cfg.model.input_cols,
            seed=feed_seed,
        )
        batches, host = input_pipeline(
            sampler, feed_batch, device,
            host_depth=cfg.data.prefetch_depth, threads=cfg.data.crop_threads,
        )
    else:
        log("no --data given: using synthetic batches (smoke mode)")
        batches = synthetic_batches(
            mode=mode,
            batch=feed_batch,
            input_size=cfg.model.input_size,
            input_cols=cfg.model.input_cols,
            seed=feed_seed,
        )

    init_params = wconv.load_init_weights(args.init_from) if args.init_from else None
    try:
        return trainer.train(
            cfg,
            batches,
            mesh=make_mesh(device),
            max_steps=args.max_steps,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            init_weights=init_params,
            log_fn=log,
            device=device,
        )
    finally:
        if host is not None:
            host.close()


def cmd_test(args):
    from .infer import predictor
    from .train import checkpoint as ckpt_lib
    from .train import trainer
    from .weights import convert as wconv

    cfg = _load_config(args.config, dict(args.set or []))
    arch = args.arch
    cfg.train.arch = arch
    state = trainer.create_train_state(cfg, arch, device=args.device)
    # weights are final before the predictor's scorer folds BN∘Scale once
    if args.weights:
        if args.weights.endswith(".npz"):
            report = wconv.match_to_model(wconv.load_npz_checkpoint(args.weights), state.model)
            print(
                f"weights: {len(report['loaded'])} layers loaded, "
                f"{len(report['skipped'])} skipped"
            )
        else:
            ckpt = ckpt_lib.Checkpointer(args.weights)
            try:
                restored = (
                    ckpt.restore_best(state) if args.restore == "best"
                    else ckpt.restore_latest(state)
                )
                if restored is None:
                    raise SystemExit(f"no {args.restore} checkpoint under {args.weights}")
            except ValueError as e:
                # a cross-stage checkpoint (e.g. a 2D-stage state driving
                # hybrid inference): merge by layer name, like the
                # reference's load_weights(by_name=True) (topology.py:3107).
                # A corrupt or wrong-config same-stage checkpoint lands here
                # too: refuse (and exit) when the merge loads fewer layers
                # than it skips.
                raw = wconv.load_init_weights(args.weights, best=args.restore == "best")
                report = wconv.match_to_model(raw, state.model)
                if not report["loaded"] or len(report["loaded"]) < len(report["skipped"]):
                    raise SystemExit(
                        f"checkpoint restore failed ({e}); by-name merge "
                        f"would load only {len(report['loaded'])} layers and "
                        f"skip {len(report['skipped'])} — refusing partial "
                        f"load of a non-cross-stage checkpoint"
                    ) from e
                print(
                    f"weights (by-name, cross-stage): "
                    f"{len(report['loaded'])} layers loaded, "
                    f"{len(report['skipped'])} skipped"
                )
    return predictor.predict_directory(
        state.model,
        cfg,
        data_dir=args.data,
        liver_mask_dir=args.livermask,
        save_dir=args.save_path,
        num_volumes=args.num_volumes,
        arch=arch,
        tiled=args.tiled,
        device=args.device,
    )


def _require_h5py():
    """Exit with the converter's message when h5py cannot be imported."""
    from .weights import convert as wconv

    try:
        wconv.h5py_module()
    except ImportError as e:
        raise SystemExit(str(e)) from None


def cmd_convert_weights(args):
    from .weights import convert as wconv

    _require_h5py()
    keys = wconv.convert_checkpoint(args.src, args.dst, submodel=args.submodel)
    print(f"converted {len(keys)} weight arrays -> {args.dst}")


def cmd_export_weights(args):
    """A port checkpoint -> Keras-2.0.8 by-name HDF5 (take a model trained
    here back to the reference stack)."""
    from .core import params as P
    from .train import checkpoint as ckpt_lib
    from .train import trainer
    from .weights import convert as wconv

    _require_h5py()
    cfg = _load_config(args.config, dict(args.set or []))
    cfg.train.arch = args.arch
    state = trainer.create_train_state(cfg, args.arch, device=args.device)
    ckpt = ckpt_lib.Checkpointer(args.checkpoint)
    restored = ckpt.restore_best(state) if args.restore == "best" else ckpt.restore_latest(state)
    if restored is None:
        raise SystemExit(f"no {args.restore} checkpoint under {args.checkpoint}")
    params, bn_state = P.to_numpy(restored.model)
    wconv.save_keras_hdf5(args.dst, params, bn_state)
    n = sum(len(v) for v in params.values())
    print(f"exported {n} weight arrays (+BN stats) -> {args.dst}")


def cmd_evaluate(args):
    from .data import nifti
    from .infer import metrics

    per_case = []
    preds, truths = [], []
    for i in range(args.num_volumes):
        pred, _ = nifti.read(Path(args.pred) / f"test-segmentation-{i}.nii")
        truth, _ = nifti.read(Path(args.truth) / f"segmentation-{i}.nii")
        pred, truth = np.asarray(pred), np.asarray(truth)
        d = metrics.dice_per_class(pred, truth)
        per_case.append(d)
        if args.global_dice:
            preds.append(pred)
            truths.append(truth)
        line = f"volume {i}: liver {d['liver']:.4f} tumor {d['tumor']:.4f}"
        if args.all_metrics:
            m = metrics.metrics_per_class(pred, truth)
            line += (
                f"  [liver voe {m['liver']['voe']:.4f} rvd {m['liver']['rvd']:+.4f}"
                f" | tumor voe {m['tumor']['voe']:.4f} rvd {m['tumor']['rvd']:+.4f}]"
            )
        print(line)
    mean = {
        k: float(np.mean([c[k] for c in per_case])) for k in ("liver", "tumor")
    }
    print(f"mean per-case Dice: liver {mean['liver']:.4f} tumor {mean['tumor']:.4f}")
    if args.global_dice:
        g = metrics.global_dice(preds, truths)
        print(f"global Dice: liver {g['liver']:.4f} tumor {g['tumor']:.4f}")


def build_parser():
    p = argparse.ArgumentParser(prog="hdenseunet_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("preprocess", help="HU-clip volumes + extract coords/boxes")
    sp.add_argument("--raw", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--num-volumes", type=int, default=None)
    sp.add_argument("--no-seg", action="store_true")
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("synth-data", help="generate a synthetic smoke dataset")
    sp.add_argument("--out", required=True)
    sp.add_argument("--num-volumes", type=int, default=3)
    sp.add_argument("--shape", default="96,96,48")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("train", help="train a stage: 2d | 3dpart | end2end")
    sp.add_argument("--arch", choices=["2d", "3dpart", "end2end"], default="2d")
    sp.add_argument("--data", default=None, help="prepared dataset dir")
    sp.add_argument("--config", default=None, help="Config JSON path")
    sp.add_argument("--batch", type=int, default=None)
    sp.add_argument("--max-steps", type=int, default=None)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--init-from", default=None,
                    help="warm-start weights: converted .npz OR a checkpoint "
                         "dir from a previous stage")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.add_argument("--set", nargs=2, action="append", metavar=("KEY", "VAL"),
                    help="config override, e.g. --set model.preset tiny")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("test", help="segment test volumes")
    sp.add_argument("--data", required=True)
    sp.add_argument("--livermask", required=True)
    sp.add_argument("--save-path", default="results")
    sp.add_argument("--weights", default=None, help=".npz or checkpoint dir")
    sp.add_argument("--restore", choices=["latest", "best"], default="latest",
                    help="which checkpoint to restore from a checkpoint dir")
    sp.add_argument("--config", default=None)
    sp.add_argument("--arch", choices=["3dpart", "end2end"], default="end2end")
    sp.add_argument("--num-volumes", type=int, default=None)
    sp.add_argument("--tiled", type=int, default=None, metavar="TILE",
                    help="x/y/z-tiled inference with TILE^2 in-plane windows "
                         "(reference predict_window_mulgpu equivalent)")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.add_argument("--set", nargs=2, action="append", metavar=("KEY", "VAL"))
    sp.set_defaults(fn=cmd_test)

    sp = sub.add_parser("convert-weights", help="Keras HDF5 -> npz of {layer}/{leaf} arrays")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--submodel", default=None,
                    choices=[None, "model_1", "denseu161", "auto3d_residual_conv"])
    sp.set_defaults(fn=cmd_convert_weights)

    sp = sub.add_parser("export-weights", help="port checkpoint -> Keras HDF5")
    sp.add_argument("checkpoint", help="checkpoint directory")
    sp.add_argument("dst", help="output .h5 path")
    sp.add_argument("--restore", choices=["latest", "best"], default="latest")
    sp.add_argument("--arch", choices=["2d", "3dpart", "end2end"], default="2d")
    sp.add_argument("--config", default=None)
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.add_argument("--set", nargs=2, action="append", metavar=("KEY", "VAL"))
    sp.set_defaults(fn=cmd_export_weights)

    sp = sub.add_parser("evaluate", help="Dice of predicted vs truth labelmaps")
    sp.add_argument("--pred", required=True)
    sp.add_argument("--truth", required=True)
    sp.add_argument("--num-volumes", type=int, required=True)
    sp.add_argument("--global-dice", action="store_true",
                    help="also report Dice over the union of all cases")
    sp.add_argument("--all-metrics", action="store_true",
                    help="also report VOE and RVD per case (LiTS secondary metrics)")
    sp.set_defaults(fn=cmd_evaluate)
    return p


def main(argv=None):
    """Run one command; returns what the command returns (``train``: the
    final TrainState, ``test``: seconds per volume)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)
