"""Checkpoints of the port's train state (hdenseunet_tpu_torch.train.checkpoint)
on CPU: a save restores to the same bits, the stage's freeze and the serving
fold are respected, the best slot and max_to_keep behave as the JAX
package's orbax Checkpointer, a save cut short leaves no newest step, a
resumed run continues bit for bit, and a NaN loss stops the loop before it
can save (as tests/test_train.py::test_nan_loss_prevents_checkpoint_save
checks for the JAX package).
"""
import math

import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.core.config import Config
from hdenseunet_tpu_torch.data.sampler import synthetic_batches
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.train import checkpoint as C, trainer as T

SIZE, COLS, BATCH = 32, 8, 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cfg(arch, tmp_path):
    cfg = Config()
    cfg.model.preset, cfg.model.input_size, cfg.model.input_cols = "tiny", SIZE, COLS
    cfg.train.arch, cfg.train.batch = arch, BATCH
    cfg.train.save_path = str(tmp_path / "exp")
    cfg.train.log_every_steps = 1
    return cfg


def _batches(arch, n, seed=0):
    gen = synthetic_batches(mode="2d" if arch == "2d" else "hybrid", batch=BATCH,
                            input_size=SIZE, input_cols=COLS, seed=seed)
    return [next(gen) for _ in range(n)]


def _assert_payloads_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            assert g.keys() == w.keys(), key
            for n in w:
                assert g[n].keys() == w[n].keys(), (key, n)
                for leaf in w[n]:
                    assert torch.equal(g[n][leaf], w[n][leaf]), (key, n, leaf)
        elif isinstance(w, torch.Tensor):
            assert torch.equal(g, w), key
        else:
            assert g == w, key


def _flags(model):
    return {(n, l): t.requires_grad for n, layer in P.layers(model).items()
            for l, t in layer.named_parameters(recurse=False)}


def test_save_restore_round_trip_keeps_freeze_and_drops_the_fold(tmp_path):
    cfg = _cfg("end2end", tmp_path)
    st = T.create_train_state(cfg, device="cpu")
    flags = _flags(st.model)
    assert not all(flags.values())  # end2end freezes the 2D BNs
    batches = _batches("end2end", 2)
    T.train_step(st, batches[0], cfg)
    ck = C.Checkpointer(tmp_path / "ck")
    ck.save(st.step, st, metric=1.0)
    saved = C.snapshot(st)
    assert saved["momentum"] and saved["step"] == 1
    T.train_step(st, batches[1], cfg)  # move every part of the state on
    L.freeze_bn_scale(st.model)
    assert not torch.equal(st.generator.get_state(), saved["generator"])
    assert ck.restore_latest(st) is st
    _assert_payloads_equal(C.snapshot(st), saved)
    _assert_payloads_equal(C.load(tmp_path / "ck" / "step-1.pt"), saved)
    assert _flags(st.model) == flags
    assert all(m.folded is None for m in st.model.modules() if isinstance(m, L.Scale))
    trained = {id(t) for g in st.optimizer.param_groups for t in g["params"]}
    assert {id(t) for t in st.optimizer.state} <= trained
    # another stage's state refuses the checkpoint and stays as it was
    other = T.create_train_state(cfg, "3dpart", device="cpu")
    before = C.snapshot(other)
    with pytest.raises(ValueError, match="'end2end' stage"):
        ck.restore_latest(other)
    _assert_payloads_equal(C.snapshot(other), before)


def test_best_slot_across_a_fresh_checkpointer_and_max_to_keep(tmp_path):
    cfg = _cfg("2d", tmp_path)
    st = T.create_train_state(cfg, device="cpu")
    kernel = P.layers(st.model)["conv1"].kernel

    def save(ck, step, metric):
        with torch.no_grad():
            kernel.fill_(float(step))
        st.step = step
        ck.save(step, st, metric=metric)

    ck = C.Checkpointer(tmp_path / "ck", max_to_keep=2)
    assert ck.restore_latest(st) is None and ck.restore_best(st) is None and ck.best_step() is None
    for step, metric in ((1, 0.9), (2, 0.4), (3, 0.7), (4, 0.8), (5, math.nan)):
        save(ck, step, metric)
    assert ck.all_steps() == [4, 5] and ck.best_step() == 2
    save(ck, 5, 0.1)  # a step already saved is not saved again
    again = C.Checkpointer(tmp_path / "ck", max_to_keep=2)
    assert again._best_seen == 0.4 and again.best_step() == 2
    save(again, 6, 0.5)  # worse than the best on disk
    assert again.best_step() == 2 and again.all_steps() == [5, 6]
    assert again.restore_best(st).step == 2 and float(kernel.detach()[0, 0, 0, 0]) == 2.0
    assert again.restore_latest(st).step == 6 and float(kernel.detach()[0, 0, 0, 0]) == 6.0
    save(again, 7, 0.3)
    assert again.best_step() == 7 and sorted(p.name for p in (tmp_path / "ck" / "best").iterdir()) == [
        "step-7.json", "step-7.pt"]
    assert C.Checkpointer(tmp_path / "ck", keep_best=False).best_step() is None


def test_a_save_cut_short_leaves_no_newest_step(tmp_path, monkeypatch):
    cfg = _cfg("2d", tmp_path)
    st = T.create_train_state(cfg, device="cpu")
    ck = C.Checkpointer(tmp_path / "ck")
    st.step = 1
    ck.save(1, st)

    def cut(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(C.torch, "save", cut)
    st.step = 2
    with pytest.raises(OSError, match="disk full"):
        ck.save(2, st, metric=0.1)
    assert ck.all_steps() == [1] and ck.best_step() is None
    monkeypatch.undo()
    assert C.Checkpointer(tmp_path / "ck").restore_latest(st).step == 1


def test_resume_continues_bit_for_bit(tmp_path):
    """4 steps of the 2D stage in one run equal 2 steps, a resume and 2
    more, given the same batches: parameters, BN statistics, momentum,
    dropout generator and step, bit for bit."""
    cfg = _cfg("2d", tmp_path)
    cfg.train.checkpoint_every_steps = 2
    batches = _batches("2d", 4, seed=3)
    one = T.train(cfg, iter(batches), max_steps=4, checkpoint_dir=str(tmp_path / "a"),
                  device="cpu", log_fn=lambda *a: None)
    logged = []
    T.train(cfg, iter(batches[:2]), max_steps=2, checkpoint_dir=str(tmp_path / "b"),
            device="cpu", log_fn=logged.append)
    two = T.train(cfg, iter(batches[2:]), max_steps=2, checkpoint_dir=str(tmp_path / "b"),
                  resume=True, device="cpu", log_fn=logged.append)
    assert logged == ["resumed from step 2"] and two.step == one.step == 4
    _assert_payloads_equal(C.snapshot(two), C.snapshot(one))
    assert C.Checkpointer(tmp_path / "b").all_steps() == [2, 4] == C.Checkpointer(tmp_path / "a").all_steps()
    _assert_payloads_equal(C.load(tmp_path / "b" / "step-4.pt"), C.load(tmp_path / "a" / "step-4.pt"))
    # without a save to resume from, resume starts afresh
    fresh = T.train(cfg, iter(batches[:1]), max_steps=1, checkpoint_dir=str(tmp_path / "c"),
                    resume=True, device="cpu", log_fn=logged.append)
    assert fresh.step == 1 and len(logged) == 1


def test_nan_loss_raises_before_any_save(tmp_path):
    cfg = _cfg("2d", tmp_path)
    cfg.train.steps_per_epoch = 100
    cfg.train.log_every_steps = 50  # a NaN would lag 49 steps at this cadence
    cfg.train.checkpoint_every_steps = 2

    def poisoned():
        for b in synthetic_batches(mode="2d", batch=BATCH, input_size=SIZE, seed=6):
            b["image"] = np.full_like(b["image"], np.nan)
            yield b

    with pytest.raises(FloatingPointError, match="non-finite loss nan at step 2"):
        T.train(cfg, poisoned(), max_steps=10, checkpoint_dir=str(tmp_path / "ck"),
                device="cpu", log_fn=lambda *a: None)
    assert C.Checkpointer(tmp_path / "ck").all_steps() == []
