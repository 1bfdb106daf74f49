"""The port's command line (hdenseunet_tpu_torch.cli) on CPU: the staged
chain synth-data -> train 2d -> train end2end --init-from -> --resume ->
test -> evaluate at the tiny preset, with the warm start counted as the
JAX package's match_to_model counts it and evaluate's text equal to the JAX
CLI's; and the entry points' default device.
"""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdenseunet_tpu import cli as j_cli
from hdenseunet_tpu.core.module import Ctx as JCtx
from hdenseunet_tpu.models import hybrid as JH
from hdenseunet_tpu.weights import convert as j_convert
from hdenseunet_tpu_torch import cli
from hdenseunet_tpu_torch.data import nifti
from hdenseunet_tpu_torch.infer import device_pipeline, predictor, sliding_window
from hdenseunet_tpu_torch.train import checkpoint, trainer
from hdenseunet_tpu_torch.weights import convert as t_convert

SIZE = 32
TINY = ["--set", "model.preset", "tiny", "--set", "model.input_size", str(SIZE),
        "--set", "data.crop_threads", "2", "--batch", "2", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _hybrid_spec():
    """(params, state) zeros in the shapes of the JAX package's abstract
    trace of the tiny hybrid."""
    ctx = JCtx(record=True, train=False)
    jax.eval_shape(lambda v: JH.apply(ctx, v, preset="tiny"), jnp.zeros((1, SIZE, SIZE, 8, 1), jnp.float32))
    params = {n: {l: np.zeros(s.shape, np.float32) for l, s in d.items()} for n, d in ctx.param_specs.items()}
    state = {n: {l: np.zeros(shape, np.float32) for l, (shape, _) in d.items()}
             for n, d in ctx.state_specs.items()}
    return params, state


def _counts(pattern, text):
    m = re.search(pattern, text)
    assert m, f"{pattern!r} not in:\n{text}"
    return tuple(int(g) for g in m.groups())


def test_staged_chain_on_the_cpu(tmp_path, capsys):
    prep, ck2d, cke = tmp_path / "prep", tmp_path / "ck2d", tmp_path / "cke"
    cli.main(["synth-data", "--out", str(prep), "--num-volumes", "2", "--shape", "48,48,24", "--seed", "5"])
    state = cli.main(["train", "--arch", "2d", "--data", str(prep), "--max-steps", "2",
                      "--checkpoint-dir", str(ck2d), "--set", "train.save_path", str(tmp_path / "e2d"), *TINY])
    assert state.step == 2

    capsys.readouterr()
    state = cli.main(["train", "--arch", "end2end", "--data", str(prep), "--max-steps", "2",
                      "--checkpoint-dir", str(cke), "--init-from", str(ck2d),
                      "--set", "train.checkpoint_every_steps", "1",
                      "--set", "train.save_path", str(tmp_path / "ee"), *TINY])
    loaded, skipped, mismatched = _counts(
        r"warm start: (\d+) layers loaded, (\d+) skipped, (\d+) shape-mismatched", capsys.readouterr().out)
    # the JAX package's count for the same weights into the tiny hybrid
    raw = t_convert.load_init_weights(ck2d)
    _, _, want = j_convert.match_to_model(raw, *_hybrid_spec(), strict_shapes=False)
    assert (loaded, skipped, mismatched) == (len(want["loaded"]), len(want["skipped"]), len(want["mismatched"]))
    assert skipped == mismatched == 0 and loaded == len(raw) > 20
    assert state.step == 2

    state = cli.main(["train", "--arch", "end2end", "--data", str(prep), "--max-steps", "1",
                      "--checkpoint-dir", str(cke), "--resume",
                      "--set", "train.save_path", str(tmp_path / "ee"), *TINY])
    assert "resumed from step 2" in capsys.readouterr().out and state.step == 3
    assert sorted(p.name for p in cke.glob("step-*.pt")) == ["step-1.pt", "step-2.pt", "step-3.pt"]

    dirs = {d: tmp_path / d for d in ("tv", "tm", "truth")}
    for d in dirs.values():
        d.mkdir()
    vol = np.load(prep / "volumes" / "volume-0.npy")
    seg = np.load(prep / "segmentations" / "segmentation-0.npy")
    nifti.write(dirs["tv"] / "test-volume-0.nii", vol.astype(np.float32))
    nifti.write(dirs["tm"] / "0-ori.nii", (seg >= 1).astype(np.int16))
    nifti.write(dirs["truth"] / "segmentation-0.nii", seg.astype(np.int16))
    test = ["test", "--data", str(dirs["tv"]), "--livermask", str(dirs["tm"]), "--num-volumes", "1",
            "--device", "cpu", "--set", "model.preset", "tiny", "--set", "infer.window_batch", "2"]
    times = cli.main([*test, "--weights", str(cke), "--save-path", str(tmp_path / "res")])
    assert len(times) == 1
    out, _ = nifti.read(tmp_path / "res" / "test-segmentation-0.nii")
    assert out.shape == vol.shape and set(np.unique(out)) <= {0, 1, 2}

    # a 2D-stage directory drives the hybrid through the by-name merge
    capsys.readouterr()
    cli.main([*test, "--weights", str(ck2d), "--restore", "best", "--save-path", str(tmp_path / "res2")])
    assert _counts(r"by-name, cross-stage\): (\d+) layers loaded, (\d+) skipped",
                   capsys.readouterr().out) == (loaded, 0)
    # the tiled scorer serves the same checkpoint (test_torch_tiled.py holds it to JAX's)
    cli.main([*test, "--weights", str(cke), "--tiled", "64", "--save-path", str(tmp_path / "res3")])
    tiled, _ = nifti.read(tmp_path / "res3" / "test-segmentation-0.nii")
    assert tiled.shape == vol.shape and set(np.unique(tiled)) <= {0, 1, 2}

    evaluate = ["evaluate", "--pred", str(tmp_path / "res"), "--truth", str(dirs["truth"]),
                "--num-volumes", "1", "--global-dice", "--all-metrics"]
    capsys.readouterr()
    cli.main(evaluate)
    got = capsys.readouterr().out
    j_cli.main(evaluate)
    assert got == capsys.readouterr().out and "mean per-case Dice" in got


def test_preprocess_command_writes_what_the_jax_cli_writes(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(7)
    for i in range(2):
        vol = rng.normal(0, 300, (16, 14, 6)).astype(np.float32)
        nifti.write(raw / f"volume-{i}.nii", vol)
        nifti.write(raw / f"segmentation-{i}.nii.gz", rng.integers(0, 3, vol.shape).astype(np.int16))
    for main, out in ((cli.main, "port"), (j_cli.main, "jax")):
        main(["preprocess", "--raw", str(raw), "--out", str(tmp_path / out), "--num-volumes", "2"])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.np[yz]"))
    assert len(files) == 6
    def arrays(path):
        if path.suffix == ".npy":
            return [np.load(path)]
        with np.load(path) as z:
            return [z[k] for k in sorted(z.files)]

    for rel in files:
        got, want = arrays(tmp_path / "port" / rel), arrays(tmp_path / "jax" / rel)
        assert len(got) == len(want) and all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(got, want)), rel


def test_test_refuses_a_merge_that_loads_fewer_layers_than_it_skips(tmp_path):
    """A checkpoint directory that neither restores (another stage's) nor
    merges by name (all but one of its layers under other names) is
    refused."""
    cfg_args = ["--set", "model.preset", "tiny", "--set", "model.input_size", str(SIZE)]
    cfg = cli._load_config(None, {"model.preset": "tiny", "model.input_size": str(SIZE)})
    st = trainer.create_train_state(cfg, "2d", device="cpu")
    payload = checkpoint.snapshot(st)
    conv1 = payload["params"]["conv1"]
    for field in ("params", "bn_state"):
        payload[field] = {f"renamed_{n}": d for n, d in payload[field].items()}
    payload["params"]["conv1"] = conv1
    (tmp_path / "ck").mkdir()
    torch.save(payload, tmp_path / "ck" / "step-1.pt")
    with pytest.raises(SystemExit, match="refusing partial load"):
        cli.main(["test", "--data", str(tmp_path), "--livermask", str(tmp_path), "--weights",
                  str(tmp_path / "ck"), "--num-volumes", "0", "--device", "cpu", *cfg_args])


@pytest.mark.parametrize("fn", [
    trainer.train, trainer.create_train_state, predictor.VolumePredictor,
    predictor.predict_directory, device_pipeline.DeviceVolumeScorer,
    predictor.TiledPredictor, device_pipeline.TiledVolumeScorer, sliding_window.WindowPredictor,
])
def test_entry_points_run_on_the_card_unless_asked(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_runs_on_the_card_unless_asked():
    parser = cli.build_parser()
    assert parser.parse_args(["train"]).device == "cuda"
    assert parser.parse_args(["test", "--data", "d", "--livermask", "m"]).device == "cuda"
    assert parser.parse_args(["train", "--device", "cpu"]).device == "cpu"
    assert parser.parse_args(["export-weights", "ck", "w.h5"]).device == "cuda"
