"""Sequence parallelism of the port on the CPU: ranks spawned as processes,
joined by gloo over a FileStore under the test's tmp_path, each running the
port's FlowModel with its SeqParallel group (``craft_tpu_torch.parallel``).
Full-width CRAFT at 64x128 (H8 = 8 grid rows), 3 iterations, with one set of
JAX-initialised weights whose sliding windows are made random (they start
at zero, which would hide a window on the wrong rows):

  * world 2, fp32, against the JAX package's Evaluator(seq_parallel=True)
    on its 8 virtual devices, within its own test's 1e-3 px;
  * world 3 (rows 3/3/2), fp32, against the port's unsharded forward,
    within 1e-4 px (the same kernels' plain versions on the same rows; only
    the fp64 moments are summed in another order);
  * world 2, mixed precision (bf16, int8 intra probs), against the port's
    unsharded mixed forward;
  * the collectives alone at world 3;
  * ``python -m craft_tpu_torch.evaluate --seq_parallel`` and
    ``Evaluator(seq_parallel=True)`` as one rank (no torchrun: an in-memory
    store) against the unsharded CLI and forward;
  * the backend each placement of ranks on cards gives.

Every multi-rank run has its own time limit and kills its ranks when it
fails or runs out, so a hung collective fails one test.  A spawned rank
imports this module, so it imports no JAX at module level.
"""

import multiprocessing
import os
import queue
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from craft_tpu_torch import evaluate as tcli
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.parallel import sp
from craft_tpu_torch.parallel.sp import row_split

H, W, ITERS = 64, 128, 3
RANKS_TIMEOUT = 300.0  # seconds for one multi-rank run, spawn included
WINDOW_STD = 1.0  # the random sliding windows: biases of O(1) logits


# ------------------------------------------------------------ rank runner

def _rank_main(rank, world, store_path, target, args, out_q):
    try:
        torch.set_num_threads(2)
        store = dist.FileStore(store_path, world)
        group = sp.init("cpu", store=store, rank=rank, world=world)
        out_q.put((rank, target(group, *args), None))
    except BaseException:  # reported to the parent, which fails the test
        out_q.put((rank, None, traceback.format_exc()))
        raise
    finally:
        sp.shutdown()


def run_ranks(tmp_path, world, target, *args, timeout=RANKS_TIMEOUT):
    """target(group, *args) on `world` spawned ranks: the list of their
    results; raises when a rank fails or the time runs out, killing every
    rank either way."""
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    store = str(tmp_path / f"store_{world}_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, target, args, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, res, err = out_q.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"{world} ranks: no result within "
                                     f"{timeout:g} s") from None
            assert err is None, f"rank {rank} failed:\n{err}"
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


# ------------------------------------------------------------ rank targets

def _sp_flow(group, mixed, sd, img1, img2):
    model = FlowModel(craft_config(mixed_precision=mixed)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        lowres, flows = model(torch.from_numpy(img1), torch.from_numpy(img2),
                              iters=ITERS, seq_parallel=group)
    return lowres.float().numpy(), flows[-1].float().numpy()


def _collectives(group, H8, W8):
    shard = group.shard(H8, W8)
    r = group.rank
    x = torch.arange(shard.u0, shard.u1, dtype=torch.float32)
    full = shard.gather(x.reshape(1, -1, 1).expand(2, -1, 3).contiguous())
    return (shard.h0, shard.h1, full.numpy(),
            float(shard.all_max(torch.tensor(float(r * r) - 1.0))),
            shard.all_sum(torch.tensor([r, 0.5])).numpy())


# ------------------------------------------------------------ fixtures

def _randomize_windows(tree, rng):
    """The variables with every sliding window ('biases' leaf) drawn from
    N(0, WINDOW_STD^2)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: (rng.randn(*np.shape(v)).astype(np.float32) * WINDOW_STD
                    if k == "biases" else _randomize_windows(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def weights():
    """(JAX variables with random windows, the port's state_dict of them
    as numpy arrays, two seeded frames)."""
    import jax
    import jax.numpy as jnp

    from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
    from craft_tpu_torch.utils.weights import state_dict_from_flax

    model = JaxFlowModel(cfg=_jax_cfg(), train=False)
    zeros = jnp.zeros((1, H, W, 3))
    variables = jax.jit(lambda key: model.init(key, zeros, zeros, iters=1))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = _randomize_windows(
        jax.tree_util.tree_map(np.asarray, variables), rng)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
    img1, img2 = (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
                  for _ in range(2))
    return variables, sd, img1, img2


def _jax_cfg():
    import craft_tpu.config as jconfig
    return jconfig.craft_config(mixed_precision=False)


def _unsharded(mixed, sd, img1, img2):
    model = FlowModel(craft_config(mixed_precision=mixed)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        lowres, flows = model(torch.from_numpy(img1), torch.from_numpy(img2),
                              iters=ITERS)
    return lowres.float().numpy(), flows[-1].float().numpy()


# ------------------------------------------------------------ tests

def test_row_split_covers_the_grid_unevenly():
    assert [row_split(8, 3, r) for r in range(3)] == [(0, 3), (3, 6), (6, 8)]
    assert [row_split(55, 4, r) for r in range(4)] == [
        (0, 14), (14, 28), (28, 42), (42, 55)]
    assert row_split(47, 2, 1) == (24, 47)


def test_collectives_at_world_3(tmp_path):
    H8, W8 = 8, 5
    out = run_ranks(tmp_path, 3, _collectives, H8, W8)
    want = np.broadcast_to(np.arange(H8 * W8, dtype=np.float32)[None, :, None],
                           (2, H8 * W8, 3))
    for rank, (h0, h1, full, mx, total) in enumerate(out):
        assert (h0, h1) == row_split(H8, 3, rank)
        np.testing.assert_array_equal(full, want)
        assert mx == 3.0  # (r^2 - 1) at rank 2
        np.testing.assert_array_equal(total, [3.0, 1.5])


def test_world2_matches_the_jax_sp_evaluator(tmp_path, weights):
    from craft_tpu.eval.evaluate import Evaluator as JaxEvaluator
    variables, sd, img1, img2 = weights
    _, jflows = JaxEvaluator(_jax_cfg(), variables, iters=ITERS,
                             seq_parallel=True)(img1, img2)
    want = np.asarray(jflows[-1])
    out = run_ranks(tmp_path, 2, _sp_flow, False, sd, img1, img2)
    for rank, (_, flow) in enumerate(out):
        err = float(np.abs(flow - want).max())
        assert err < 1e-3, (rank, err)
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_world3_uneven_rows_match_the_unsharded_forward(tmp_path, weights):
    _, sd, img1, img2 = weights
    want_lo, want = _unsharded(False, sd, img1, img2)
    out = run_ranks(tmp_path, 3, _sp_flow, False, sd, img1, img2)
    for rank, (lowres, flow) in enumerate(out):
        assert float(np.abs(flow - want).max()) < 1e-4, rank
        assert float(np.abs(lowres - want_lo).max()) < 1e-4, rank


def test_world2_mixed_precision_matches_the_unsharded_forward(tmp_path,
                                                              weights):
    """bf16 sites, the int8 intra probs and the bf16 level 0 of B9: the
    shards' bf16 roundings are the unsharded ones except where the moments'
    fp64 sums, taken in another order, move a normed value across a
    rounding boundary."""
    _, sd, img1, img2 = weights
    _, want = _unsharded(True, sd, img1, img2)
    out = run_ranks(tmp_path, 2, _sp_flow, True, sd, img1, img2)
    for rank, (_, flow) in enumerate(out):
        assert np.isfinite(flow).all()
        assert float(np.abs(flow - want).max()) < 1e-2, rank


def test_cli_seq_parallel_as_one_rank_matches_unsharded(tmp_path, weights):
    import test_torch_data as td

    _, sd, _, _ = weights
    pth = str(tmp_path / "craft.pth")
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()},
               pth)
    root = str(tmp_path / "data")
    td.write_sintel(os.path.join(root, "Sintel"), np.random.RandomState(1),
                    scenes=("alley_1",), frames=2, H=H, W=W)
    argv = ["--model", pth, "--craft", "--setrans", "--fullprec", "--iters",
            str(ITERS), "--device", "cpu", "--dataset", "sintel",
            "--data_root", root]
    want = tcli.main(argv)
    try:
        got = tcli.main(argv + ["--seq_parallel"])
        group = sp.init("cpu")  # the CLI's group, as it made it
        assert (group.world, group.backend) == (1, "gloo")
    finally:
        sp.shutdown()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert abs(got[key] - w) <= 1e-4, (key, got[key], w)


def test_evaluator_as_one_rank_matches_unsharded(weights):
    """Evaluator(seq_parallel=True) without torchrun is rank 0 of a one-rank
    group; its flow is the unsharded one."""
    from craft_tpu_torch.eval import evaluate as teval

    _, sd, img1, img2 = weights
    _, want = _unsharded(False, sd, img1, img2)
    state = {k: torch.from_numpy(v) for k, v in sd.items()}
    try:
        ev = teval.Evaluator(craft_config(mixed_precision=False), state,
                             iters=ITERS, device="cpu", seq_parallel=True)
        assert (ev.seq_parallel.world, ev.seq_parallel.rank) == (1, 0)
        assert ev.seq_parallel is sp.init("cpu")
        _, flows = ev(img1, img2)
    finally:
        sp.shutdown()
    assert float(np.abs(flows[-1] - want).max()) < 1e-4
    assert teval.Evaluator(craft_config(mixed_precision=False), state,
                           iters=ITERS, device="cpu").seq_parallel is None


@pytest.mark.parametrize("cards,backend", [
    (("GPU-a", "GPU-b"), "nccl"),  # one visible card per rank
    (("GPU-a", "GPU-a"), "gloo"),  # two ranks on one card
    (("", ""), "gloo"),            # ranks on the CPU
    (("GPU-a",), "nccl"),          # one rank
])
def test_placement_backend_follows_the_cards(monkeypatch, cards, backend):
    """Every rank posts its card's id to the store and picks the same
    backend from all of them; a launcher's LOCAL_WORLD_SIZE and the number
    of visible cards do not enter."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(len(cards)))
    store = dist.HashStore()
    with ThreadPoolExecutor(len(cards)) as pool:
        got = list(pool.map(
            lambda r: sp.placement_backend(store, r, len(cards), cards[r]),
            range(len(cards))))
    assert got == [backend] * len(cards)
