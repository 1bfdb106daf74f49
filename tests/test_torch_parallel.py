"""The port's mesh and multi-process runtime (hdenseunet_tpu_torch.core.mesh,
hdenseunet_tpu_torch.parallel) against the JAX package's, on the CPU.

The in-process tests run without a process group: the one-rank mesh, the
no-op ``initialize`` and its refusals of a broken environment, the sharded
dropout mask. The rest run two real gloo ranks, this file run as a script
(``python tests/test_torch_parallel.py '<json>'``) in two processes that
meet at a ``file://`` store under the test's tmp_path, each with a wall
limit: the batch helpers' rows and errors against JAX's on a 2-device mesh,
``replicate`` and the flat all-reduce, and live BatchNorm∘Scale∘ReLU (K6's
plain version, its statistics and S1/S2 merged across the ranks) and K2's
loss sums, gradients included, against one process over the whole batch.

:func:`run_ranks` is also the launcher of tests/test_torch_dp_*.py.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.core import mesh as M
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.ops.bn_live import BNLive
from hdenseunet_tpu_torch.ops.wce import weighted_ce
from hdenseunet_tpu_torch.parallel import multihost as H

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = datetime.timedelta(seconds=90)  # rendezvous and each collective
WALL = 150.0  # seconds for a whole group of ranks, then the test fails
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
EPS = 1e-3
GLOBAL_ROWS = 4


def run_ranks(script: Path, tmp_path: Path, world: int = 2, wall: float = WALL, **job) -> list:
    """Run ``script`` (a test file whose ``__main__`` calls its worker) as
    ``world`` gloo ranks meeting at a file store under ``tmp_path``; each
    rank writes its results with ``torch.save`` to the path in its job.
    Returns the results in rank order; fails the test if any rank fails or
    the group outlives ``wall`` seconds (every rank is then killed)."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    store = tmp_path / f"store-{time.monotonic_ns()}"
    outs = [tmp_path / f"rank{r}-{store.name}.pt" for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), json.dumps(dict(
                job, init=f"file://{store}", world=world, rank=r, out=str(outs[r])))],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + wall
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks of {script.name} outlived {wall} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def join(job: dict) -> None:
    """A worker's start: threads capped, the gloo group joined."""
    torch.set_num_threads(2)
    H.initialize(
        init_method=job["init"], world_size=job["world"], rank=job["rank"], backend="gloo",
        timeout=RANK_TIMEOUT,
    )


def _global_inputs():
    """Seeded whole-batch inputs of the live BN and loss checks."""
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, (GLOBAL_ROWS, 3, 5, 6)).astype(np.float32)
    w = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    logits = rng.normal(0.0, 3.0, (GLOBAL_ROWS * 7, 3)).astype(np.float32)
    labels = rng.integers(0, 3, GLOBAL_ROWS * 7).astype(np.int32)
    mask = (rng.random(GLOBAL_ROWS * 7) < 0.7).astype(np.float32)
    params = rng.normal((1.0, 0.0, 1.0, 0.0), 0.4, (3, 4)).T.astype(np.float32)
    return x, w, logits, labels, mask, params


def _live_bn_and_loss(x, w, logits, labels, mask, params, group):
    """Live BatchNorm∘Scale∘ReLU of x through K6 (``BNLive``, its plain
    version; the global batch's statistics under ``group``) weighted and
    summed, and the weighted CE; returns values and gradients, the BN and
    Scale leaves' this rank's share."""
    xt = torch.tensor(x, requires_grad=True)
    leaves = [torch.tensor(p, requires_grad=True) for p in params]  # gamma_bn, beta_bn, gamma_s, beta_s
    y, mean, var = BNLive.apply(xt, *leaves, EPS, True, group)
    (y * torch.tensor(w)).sum().backward()
    lt = torch.tensor(logits, requires_grad=True)
    loss = weighted_ce(lt, torch.tensor(labels), torch.tensor(mask), (0.78, 0.65, 8.57), group)
    loss.backward()
    return dict(y=y.detach().numpy(), mean=mean.numpy(), var=var.numpy(), x_grad=xt.grad.numpy(),
                leaf_grads=np.stack([t.grad.numpy() for t in leaves]), loss=float(loss.detach()),
                logits_grad=lt.grad.numpy())


def worker(job: dict) -> None:
    join(job)
    mesh = M.make_mesh("cpu")
    rank, world = M.axis_rank(mesh), M.axis_size(mesh)
    group = M.axis_group(mesh)
    out = dict(rank=rank, world=world, names=mesh.mesh_dim_names, primary=H.is_primary(),
               index=H.process_index(), count=H.process_count(), again=H.initialize())
    for name, fn in (("divisible", lambda: M.check_batch_divisible(3, mesh)),
                     ("local", lambda: H.local_batch_size(3))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["local_batch"] = H.local_batch_size(8)
    out["rows"] = M.shard_batch(mesh, {"image": np.arange(16).reshape(8, 2)})["image"]
    t = torch.full((3,), float(rank))
    torch.manual_seed(rank)
    lin = torch.nn.Linear(4, 2)
    M.replicate(mesh, [t])
    M.replicate(mesh, lin)
    out["replicated"] = (t.numpy(), lin.weight.detach().numpy(), lin.bias.detach().numpy())
    a, b = torch.full((2,), rank + 1.0), torch.full((3,), 10.0 * (rank + 1))
    M.all_reduce_([a, b], group)
    out["summed"] = (a.numpy(), b.numpy())
    dt = H.global_batch_from_local(mesh, {"image": np.zeros((2, 5), np.float32)})["image"]
    out["dtensor"] = (tuple(dt.shape), tuple(dt.to_local().shape))
    x, w, logits, labels, mask, params = _global_inputs()
    n, m = GLOBAL_ROWS // world, len(logits) // world
    out["dp"] = _live_bn_and_loss(
        x[rank * n:(rank + 1) * n], w[rank * n:(rank + 1) * n], logits[rank * m:(rank + 1) * m],
        labels[rank * m:(rank + 1) * m], mask[rank * m:(rank + 1) * m], params, group,
    )
    torch.save(out, job["out"])
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# one process, no group
# --------------------------------------------------------------------------


@pytest.fixture
def no_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()


def test_one_rank_mesh_without_process_group(no_env):
    """No group: a one-rank 'data' mesh that issues no collective, and
    batch helpers that see the whole batch, as JAX's 1-device mesh."""
    from hdenseunet_tpu.core import mesh as JM

    import jax

    mesh = M.make_mesh("cpu")
    assert isinstance(mesh, M.LocalMesh) and mesh.mesh_dim_names == (M.DATA_AXIS,) == ("data",)
    assert (M.axis_size(mesh), M.axis_rank(mesh), M.axis_group(mesh)) == (1, 0, None)
    assert (M.axis_size(None), M.axis_rank(None), M.axis_group(None)) == (1, 0, None)
    jmesh = JM.make_mesh(jax.devices()[:1])
    for batch in (1, 3, 8):
        M.check_batch_divisible(batch, mesh)
        JM.check_batch_divisible(batch, jmesh)
        assert H.local_batch_size(batch) == batch
    batch = {"image": np.arange(12).reshape(6, 2), "label": np.arange(6)}
    rows = M.shard_batch(mesh, batch)
    assert all(np.array_equal(rows[k], batch[k]) for k in batch)
    t = torch.arange(3.0)
    assert M.replicate(mesh, [t])[0] is t and torch.equal(t, torch.arange(3.0))
    assert H.is_primary() and (H.process_index(), H.process_count()) == (0, 1)


def test_default_mesh_without_a_card_raises(no_env):
    """No group, no ``device`` and no card: ``make_mesh()`` raises rather
    than pick the CPU; in a subprocess with CUDA hidden, so the test asks
    the same question where a card is present. ``make_mesh('cpu')`` still
    gives the CPU mesh."""
    code = (
        "from hdenseunet_tpu_torch.core import mesh as M\n"
        "m = M.make_mesh('cpu')\n"
        "assert isinstance(m, M.LocalMesh) and m.device_type == 'cpu', m\n"
        "try:\n"
        "    M.make_mesh()\n"
        "except RuntimeError as e:\n"
        "    print(e)\n"
        "else:\n"
        "    raise SystemExit('make_mesh() returned a mesh without a card')\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no CUDA card; pass device='cpu'" in out.stdout


def test_initialize_is_a_noop_without_environment(no_env):
    assert H.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_without_a_card_needs_gloo(no_env, tmp_path):
    """A group to join, no ``backend`` and no card: ``initialize`` raises
    and joins nothing, rather than quietly make a CPU group;
    ``backend='gloo'`` joins one. In a subprocess with CUDA hidden, so the
    test asks the same question where a card is present."""
    code = (
        "import torch.distributed as dist\n"
        "from hdenseunet_tpu_torch.parallel import multihost as H\n"
        f"store = 'file://{tmp_path}/store'\n"
        "try:\n"
        "    H.initialize(init_method=store, world_size=1, rank=0)\n"
        "except RuntimeError as e:\n"
        "    print(e)\n"
        "else:\n"
        "    raise SystemExit('initialize() joined a group without a card')\n"
        "assert not dist.is_initialized()\n"
        "assert H.initialize(init_method=store + '2', world_size=1, rank=0, backend='gloo') is False\n"
        "assert dist.get_backend() == 'gloo'\n"
        "dist.destroy_process_group()\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no CUDA card; pass backend='gloo'" in out.stdout


@pytest.mark.parametrize("case", ["no_master_addr", "world_without_rank", "rank_outside", "timeout"])
def test_initialize_raises_on_a_broken_environment(no_env, monkeypatch, tmp_path, case):
    """A configured environment that cannot be joined raises; nothing falls
    back to a single process."""
    kwargs = dict(backend="gloo")
    if case == "no_master_addr":
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "0")
        error = ValueError
    elif case == "world_without_rank":
        monkeypatch.setenv("WORLD_SIZE", "2")
        error = ValueError
    elif case == "rank_outside":
        kwargs.update(world_size=2, rank=2, init_method=f"file://{tmp_path}/store")
        error = ValueError
    else:  # a world of 2 that rank 1 never joins
        kwargs.update(world_size=2, rank=0, init_method=f"file://{tmp_path}/store",
                      timeout=datetime.timedelta(seconds=2))
        error = RuntimeError
    with pytest.raises(error):
        H.initialize(**kwargs)
    assert not torch.distributed.is_initialized()


def test_local_device_and_put_batch(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert H.local_device() == torch.device("cuda", 3)
    monkeypatch.delenv("LOCAL_RANK")
    assert H.local_device() == torch.device("cuda", 0)
    batch = {"image": np.ones((2, 4, 4, 3), np.float32), "label": np.ones((2, 4, 4), np.uint8)}
    got = H.put_batch(batch, "cpu")
    assert got["image"].dtype == torch.float32 and got["label"].dtype == torch.int32
    assert torch.equal(got["image"], torch.ones(2, 4, 4, 3))


@pytest.mark.parametrize("shape, fmt", [
    ((4, 3, 6, 5), torch.contiguous_format), ((4, 3, 6, 5), torch.channels_last),
    ((6, 2, 4, 4, 3), torch.channels_last_3d),
])
@pytest.mark.parametrize("ranks", [2, 3])
def test_sharded_dropout_is_rows_of_the_single_process_mask(shape, fmt, ranks):
    """Each rank's mask is its rows of the mask one process draws from the
    same seed over the whole batch."""
    n = shape[0] * ranks
    x = torch.randn((n, *shape[1:])).contiguous(memory_format=fmt) + 3.0
    want = L.dropout(x, 0.3, torch.tensor(11))
    for r in range(ranks):
        rows = x[r * shape[0]:(r + 1) * shape[0]]
        got = L.dropout(rows, 0.3, torch.tensor(11), shard=(r, ranks))
        assert torch.equal(got, want[r * shape[0]:(r + 1) * shape[0]]), r


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(Path(__file__), tmp_path_factory.mktemp("ranks"))


def test_two_ranks_mesh_and_batch_helpers(two_ranks):
    """Rank r's rows are the rows JAX's shard_batch puts on device r of a
    2-device mesh; the errors are JAX's."""
    import jax

    from hdenseunet_tpu.core import mesh as JM

    jmesh = JM.make_mesh(jax.devices()[:2])
    with pytest.raises(ValueError) as jerr:
        JM.check_batch_divisible(3, jmesh)
    placed = JM.shard_batch(jmesh, {"image": np.arange(16).reshape(8, 2)})["image"]
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r, out in enumerate(two_ranks):
        assert (out["rank"], out["world"], out["names"]) == (r, 2, ("data",))
        assert (out["primary"], out["index"], out["count"], out["again"]) == (r == 0, r, 2, True)
        assert out["divisible"] == str(jerr.value)
        assert out["local"] == "global batch 3 not divisible by process count 2"
        assert out["local_batch"] == 4
        np.testing.assert_array_equal(out["rows"], shards[jmesh.devices[r]])
        assert out["dtensor"] == ((4, 5), (2, 5))


def test_two_ranks_replicate_and_all_reduce(two_ranks):
    (t0, w0, b0), (t1, w1, b1) = (out["replicated"] for out in two_ranks)
    np.testing.assert_array_equal(t0, np.zeros(3))
    np.testing.assert_array_equal(t1, np.zeros(3))
    assert np.array_equal(w0, w1) and np.array_equal(b0, b1)
    torch.manual_seed(0)
    np.testing.assert_array_equal(w0, torch.nn.Linear(4, 2).weight.detach().numpy())
    for out in two_ranks:
        np.testing.assert_array_equal(out["summed"][0], np.full(2, 3.0))
        np.testing.assert_array_equal(out["summed"][1], np.full(3, 30.0))


def test_two_ranks_live_bn_and_loss_match_one_process(two_ranks):
    """Live BN∘Scale∘ReLU through K6 over two ranks' rows, its statistics
    and S1/S2 merged across them, and K2's global loss equal one process's
    over the whole batch: y, mean, var and x's gradient, the BN and Scale
    leaves' gradients summed over the ranks (as the trainer's all-reduce
    sums them), the loss and the logits' gradient (float32; the merge sums
    in float64, one process in float32). The ranks' statistics and loss
    agree bit for bit."""
    one = _live_bn_and_loss(*_global_inputs(), None)
    a, b = (out["dp"] for out in two_ranks)
    for key in ("mean", "var", "loss"):
        assert np.array_equal(a[key], b[key]), key  # the ranks agree bit for bit
        np.testing.assert_allclose(a[key], one[key], rtol=1e-6, atol=1e-6, err_msg=key)
    for key in ("y", "x_grad", "logits_grad"):
        got = np.concatenate([a[key], b[key]])
        np.testing.assert_allclose(got, one[key], rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(a["leaf_grads"] + b["leaf_grads"], one["leaf_grads"], rtol=1e-5,
                               atol=1e-5, err_msg="leaf_grads")


if __name__ == "__main__":
    worker(json.loads(sys.argv[1]))
