"""The port's data-parallel train step (hdenseunet_tpu_torch.train.trainer
with ``mesh=``) on two gloo ranks against one process and against the JAX
package's step on a 2-device mesh, on the CPU.

Two ranks (this file run as a script, launched by
``test_torch_parallel.run_ranks``) each take their 2 rows of a global batch
of 4, for the 2D stage and end2end, tiny preset, float32, remat on:

* the ranks agree bit for bit: loss, gradients, parameters and moving
  statistics after the step;
* with dropout on, the step equals the port's one-process step on the
  whole batch (each rank's masks are its rows of the one process's);
* with dropout as the identity in both packages, the step equals
  ``hdenseunet_tpu.train.trainer.make_train_step`` on a 2-device mesh
  (gradients from ``jax.value_and_grad`` of the same loss on that mesh);
* ``train(..., mesh=)`` with a checkpoint: rank 0 writes, and the save
  restores in one process bit for bit.

The bars are tests/test_torch_train.py's (LOSS_RTOL, STAT_TOL,
GRAD_MAX_RTOL). The JAX side runs remat off (the same function).
"""
from __future__ import annotations

import concurrent.futures
import itertools
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.core import mesh as M, params as P
from hdenseunet_tpu_torch.core.config import Config
from hdenseunet_tpu_torch.data.sampler import synthetic_batches
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.train import checkpoint as C, trainer as T
from test_torch_parallel import join, run_ranks

SIZE, COLS, GLOBAL_BATCH = 32, 8, 4
ARCHS = ("2d", "end2end")


def port_config(arch: str) -> Config:
    cfg = Config()
    cfg.model.preset, cfg.model.input_size, cfg.model.input_cols = "tiny", SIZE, COLS
    cfg.train.arch, cfg.train.batch, cfg.train.log_every_steps = arch, GLOBAL_BATCH, 1
    return cfg


def global_batch(arch: str, seed: int = 0) -> dict:
    mode = "2d" if arch == "2d" else "hybrid"
    return next(synthetic_batches(mode=mode, batch=GLOBAL_BATCH, input_size=SIZE, input_cols=COLS, seed=seed))


def port_step(arch, params, state, batch, mesh, *, dropout: bool) -> tuple[T.TrainState, float]:
    """One port step from the given weights on ``batch`` (this rank's rows
    under ``mesh``); dropout patched to the identity unless ``dropout``."""
    kept = L.dropout
    if not dropout:
        L.dropout = lambda x, rate, seed=None, **kw: x
    try:
        st = T.create_train_state(port_config(arch), arch, device="cpu")
        P.from_numpy(st.model, params, state)
        loss = float(T.train_step(st, batch, port_config(arch), mesh))
    finally:
        L.dropout = kept
    return st, loss


def eval_loss(arch, params, state, batch, mesh) -> float:
    st = T.create_train_state(port_config(arch), arch, device="cpu")
    P.from_numpy(st.model, params, state)
    return float(T.eval_step(st, batch, port_config(arch), mesh))


def record(st: T.TrainState, loss: float) -> dict:
    """A step's result in the JAX layout: loss, gradients, parameters, moving
    statistics and the stage's labels (test_torch_train's ``want``). A
    trained leaf the loss never reads has no .grad; JAX's is 0."""
    params, state = P.to_numpy(st.model)
    grads = {
        name: {leaf: P.to_jax_layout(leaf, torch.zeros_like(t) if t.grad is None else t.grad)
               for leaf, t in layer.named_parameters(recurse=False) if t.requires_grad}
        for name, layer in P.layers(st.model).items()
    }
    return dict(loss=loss, grads=grads, params=params, state=state, labels=st.labels)


def rebuild(arch: str, rec: dict) -> T.TrainState:
    """A one-process TrainState holding a rank's post-step weights and
    gradients, for test_torch_train.assert_step_matches."""
    st = T.create_train_state(port_config(arch), arch, device="cpu")
    P.from_numpy(st.model, rec["params"], rec["state"])
    for name, layer in P.layers(st.model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            g = rec["grads"].get(name, {}).get(leaf)
            t.grad = None if g is None else P.to_torch_layout(leaf, g)
    return st


def worker(job: dict) -> None:
    join(job)
    inputs = torch.load(job["inputs"], weights_only=False)
    mesh = M.make_mesh("cpu")
    out = {}
    for arch in ARCHS:
        params, state = inputs[arch]["init"]
        rows = M.shard_batch(mesh, inputs[arch]["batches"][0])
        for dropout in (False, True):
            st, loss = port_step(arch, params, state, rows, mesh, dropout=dropout)
            out[arch, dropout] = record(st, loss)
        out[arch, "eval"] = eval_loss(arch, params, state, rows, mesh)
    cfg = port_config("2d")
    cfg.train.save_path = job["save_path"]
    feed = (M.shard_batch(mesh, b) for b in inputs["2d"]["batches"])
    st = T.train(cfg, feed, mesh=mesh, max_steps=2, checkpoint_dir=job["ckpt"], device="cpu",
                 log_fn=lambda *a: None)
    out["train"] = C.snapshot(st)
    torch.save(out, job["out"])
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs():
    import jax
    import test_torch_train as R

    return {
        arch: dict(init=jax.tree.map(np.asarray, R.jax_init(arch)),
                   batches=[global_batch(arch, seed) for seed in (0, 1)])
        for arch in ARCHS
    }


@pytest.fixture(scope="module", autouse=True)
def ranks(inputs, tmp_path_factory):
    """The two ranks, started first and run beside the one-process and JAX
    references; a test takes their results with ``.result()``."""
    tmp = tmp_path_factory.mktemp("dp_train")
    torch.save(inputs, tmp / "inputs.pt")
    job = dict(inputs=str(tmp / "inputs.pt"), ckpt=str(tmp / "ck"), save_path=str(tmp / "exp"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield dict(future=pool.submit(run_ranks, Path(__file__), tmp, **job), **job)
    pool.shutdown()


@pytest.fixture(scope="module")
def outs(ranks):
    return ranks["future"].result()


def jax_mesh_step(arch: str, params, state, batch) -> dict:
    """make_train_step on a 2-device 'data' mesh, dropout as the identity,
    remat off: loss, parameters and statistics after the step; gradients
    from jax.value_and_grad of the same loss on the same sharded batch."""
    import jax
    import jax.numpy as jnp
    import test_torch_train as R

    from hdenseunet_tpu.core import mesh as JM
    from hdenseunet_tpu.models import layers as JL
    from hdenseunet_tpu.train import optimizer as JOpt, trainer as JT

    cfg, _ = R.configs(arch)
    cfg.train.batch, cfg.train.remat, cfg.train.donate_state = GLOBAL_BATCH, False, False
    mesh = JM.make_mesh(jax.devices()[:2])
    placed = JM.shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    tx, labels = JOpt.make_optimizer(params, arch, cfg.train.lr, cfg.train.momentum)
    ts = JT.TrainState(jnp.zeros((), jnp.int32), params, state, tx.init(params), jax.random.key(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "dropout", lambda ctx, x, rate: x)
        new, loss = JT.make_train_step(tx, cfg, mesh, arch)(ts, placed)
        grads = jax.jit(jax.grad(
            lambda p: JT._forward_loss(p, state, placed, jax.random.key(1), arch=arch, cfg=cfg)[0]
        ))(params)
    return dict(loss=float(loss), grads=grads, params=new.params, state=new.bn_state, labels=labels)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_equal_jax_mesh_step(inputs, ranks, arch):
    """First in the file: JAX compiles while the ranks run."""
    import test_torch_train as R

    params, state = inputs[arch]["init"]
    want = jax_mesh_step(arch, params, state, inputs[arch]["batches"][0])
    rec = ranks["future"].result()[0][arch, False]
    R.assert_step_matches(arch, want, rebuild(arch, rec), rec["loss"], params)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropout", [False, True])
def test_ranks_agree_bit_for_bit(outs, arch, dropout):
    a, b = outs[0][arch, dropout], outs[1][arch, dropout]
    assert a["loss"] == b["loss"]
    for key in ("grads", "params", "state"):
        for name, leaves in a[key].items():
            for leaf, arr in leaves.items():
                assert np.array_equal(arr, b[key][name][leaf]), (key, name, leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_equal_one_process_with_dropout(inputs, outs, arch):
    import test_torch_train as R

    params, state = inputs[arch]["init"]
    st, loss = port_step(arch, params, state, inputs[arch]["batches"][0], None, dropout=True)
    R.assert_step_matches(arch, outs[0][arch, True], st, loss, params)
    one = eval_loss(arch, params, state, inputs[arch]["batches"][0], None)
    assert abs(outs[0][arch, "eval"] - one) <= R.LOSS_RTOL * abs(one)


def test_two_rank_checkpoint_restores_in_one_process(ranks, outs):
    """train(mesh=) over two ranks: rank 0 alone wrote the save and the
    history; one process restores the save bit for bit, and the ranks'
    final states are the same."""
    cfg = port_config("2d")
    st = T.create_train_state(cfg, "2d", device="cpu")
    assert C.Checkpointer(ranks["ckpt"]).restore_latest(st).step == 2
    restored = C.snapshot(st)
    for out in outs:
        assert _payloads_equal(out["train"], restored)
    lines = (Path(ranks["save_path"]) / "history" / "lossbatch.txt").read_text().split()
    assert len(lines) == 2 and all(np.isfinite(float(v)) for v in lines)


def _payloads_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_payloads_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("world", [1, 2, 4])
def test_metrics_logger_divides_by_the_world_size(tmp_path, monkeypatch, world):
    """slices/s/chip is the global batch's slices over the ranks' cards
    (trainer.py:248-255); only the primary rank writes the history."""
    clock = itertools.chain([0.0], itertools.repeat(2.0))
    monkeypatch.setattr(T, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    logger = T.MetricsLogger(str(tmp_path / f"w{world}"), slices_per_sample=8, world_size=world,
                             primary=world == 1)
    for _ in range(3):
        logger.log_step(0.5, GLOBAL_BATCH)
    stats = logger.end_epoch()
    assert stats["samples_per_sec"] == 3 * GLOBAL_BATCH / 2.0
    assert stats["slices_per_sec_per_chip"] == 3 * GLOBAL_BATCH * 8 / 2.0 / world
    assert (tmp_path / f"w{world}" / "history" / "lossbatch.txt").exists() == (world == 1)


if __name__ == "__main__":
    worker(json.loads(sys.argv[1]))
