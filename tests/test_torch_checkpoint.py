"""The port's checkpoints and restart supervision against the JAX
package: a checkpoint written by the reference's ``CheckpointManager``
restores in the port's, and the port's files are the reference's byte
for byte (bf16 leaves included, CRCs equal), so that the reference reads
them as its own; ``latest_step`` falls back past a damaged step; atomic
writes, ``keep`` and the async save; ``RestartableLoop`` resuming,
restoring and replaying, and its diagnostics.

The reference's own restore cannot read a bf16 leaf back (``np.load``
returns the raw ``|V2`` words, which ``jnp.asarray`` refuses); the port
reads them as 16-bit words viewed as ``torch.bfloat16``.  Everything is
compared exactly: a checkpoint holds bits.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.checkpoint import fault_tolerance as jft  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import fault_tolerance as ft  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402


def _state(seed=0, name="hymba-1.5b"):
    """A ``(params, opt_state)`` pair of a smoke config in both packages'
    forms: bf16 matrices, f32 SSM leaves, f32 moments, an int32 step."""
    cfg = get_config(name).smoke()
    npp = carry.numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                     .astype(np.float32), npp)
    v = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape))
                     .astype(np.float32), npp)
    jp = jax.tree_util.tree_map_with_path(
        lambda k, a: jnp.asarray(a, jnp.float32 if tf.is_f32_leaf(
            jax.tree_util.keystr(k)) else jnp.bfloat16), npp)
    jstate = (jp, jopt.AdamWState(step=jnp.int32(7),
                                  m=jax.tree.map(jnp.asarray, m),
                                  v=jax.tree.map(jnp.asarray, v)))
    tstate = (carry.params_from_jax(npp, device="cpu"),
              carry.opt_state_from_numpy(7, m, v, device="cpu"))
    return jstate, tstate


def _same_tree(a, b):
    pa, pb = ckpt.leaf_paths(a), ckpt.leaf_paths(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def test_leaf_paths_are_the_reference_keystr():
    jstate, tstate = _state()
    want = [k for k, _ in jckpt._leaf_paths(jstate)]
    got = [k for k, _ in ckpt.leaf_paths(tstate)]
    assert got == want
    assert "[1].step" in got and "[1].m['embed']" in got \
        and "[0]['layers']['attn']['wq']" in got


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _state()
    jckpt.CheckpointManager(str(tmp_path), async_save=False).save(5, jstate)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5 and mgr.verify(5)
    like = _state(seed=9)[1]                     # other values, same tree
    got = mgr.restore(5, like)
    _same_tree(got, tstate)
    assert got[1].step == 7 and got[0]["embed"].dtype == torch.bfloat16


def test_port_checkpoint_is_the_reference_byte_for_byte(tmp_path):
    jstate, tstate = _state()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.CheckpointManager(str(jdir), async_save=False).save(3, jstate)
    ckpt.CheckpointManager(str(tdir), async_save=False).save(3, tstate)
    jd, td = jdir / "step_0000000003", tdir / "step_0000000003"
    names = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == names
    for n in names:
        if n != "manifest.json":
            assert (td / n).read_bytes() == (jd / n).read_bytes(), n
    jm, tm = (json.loads((d / "manifest.json").read_text()) for d in (jd, td))
    assert tm["step"] == jm["step"] and tm["leaves"] == jm["leaves"]
    assert any(v["dtype"] == "bfloat16" for v in tm["leaves"].values())
    # the reference verifies the port's checkpoint, CRCs and all
    assert jckpt.CheckpointManager(str(tdir)).latest_step() == 3


def test_reference_restores_a_port_checkpoint_of_f32_leaves(tmp_path):
    """The reference's restore of a port-written tree (f32 leaves and the
    int32 step: the dtypes its own restore reads back)."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    state = (tf.unflatten((k, torch.from_numpy(a))
                          for k, a in tf.leaves(tree)),
             optimizer.AdamWState(step=2, m={"x": torch.ones(2)},
                                  v={"x": torch.zeros(2)}))
    ckpt.CheckpointManager(str(tmp_path), async_save=False).save(1, state)
    like = (jax.tree.map(jnp.zeros_like, tree),
            jopt.AdamWState(step=jnp.int32(0), m={"x": jnp.zeros(2)},
                            v={"x": jnp.zeros(2)}))
    got = jckpt.CheckpointManager(str(tmp_path)).restore(1, like)
    np.testing.assert_array_equal(np.asarray(got[0]["a"]), tree["a"])
    np.testing.assert_array_equal(np.asarray(got[0]["b"]["c"]),
                                  tree["b"]["c"])
    assert int(got[1].step) == 2
    np.testing.assert_array_equal(np.asarray(got[1].m["x"]), np.ones(2))


def test_latest_step_skips_a_damaged_checkpoint(tmp_path):
    _, tstate = _state()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=5, async_save=False)
    for s in (2, 4, 6):
        mgr.save(s, tstate)
    assert mgr.all_steps() == [2, 4, 6] and mgr.latest_step() == 6
    f = tmp_path / "step_0000000006" / "leaf_00000.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0x40                              # one flipped bit
    f.write_bytes(bytes(raw))
    assert not mgr.verify(6) and mgr.latest_step() == 4
    # the reference agrees
    assert jckpt.CheckpointManager(str(tmp_path)).latest_step() == 4
    os.remove(tmp_path / "step_0000000004" / "manifest.json")
    assert mgr.latest_step() == 2


def test_keep_async_save_and_atomic_publish(tmp_path):
    _, tstate = _state()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, tstate)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002",
                                            "step_0000000003"]
    # the snapshot is taken at save time, not when the thread writes
    params = tstate[0]
    before = params["embed"].clone()
    mgr.save(4, tstate)
    params["embed"].add_(1.0)
    mgr.wait()
    got = mgr.restore(4, tstate)
    assert torch.equal(got[0]["embed"], before)
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = (dict(tstate[0], embed=torch.zeros(3, 3, dtype=torch.bfloat16)),
               tstate[1])
        mgr.restore(4, bad)


# --------------------------------------------------------------------------
# RestartableLoop and StragglerMonitor, against the reference's
# --------------------------------------------------------------------------

def _counter_run(pkg, directory, fail_at=(), n_steps=7, start=None,
                 ckpt_every=2, max_restarts=10):
    """A loop whose state is a step counter and a running sum: each step
    adds its index; steps in ``fail_at`` raise the first time, after
    updating the state (as an in-place optimizer would)."""
    mgr_cls = jckpt.CheckpointManager if pkg == "jax" else \
        ckpt.CheckpointManager
    loop_cls = jft.RestartableLoop if pkg == "jax" else ft.RestartableLoop
    arr = (lambda x: jnp.asarray(x, jnp.float32)) if pkg == "jax" else \
        (lambda x: torch.tensor(x, dtype=torch.float32))
    seen, failed = [], set()

    def step_fn(state, i):
        seen.append(i)
        state = {"sum": state["sum"] + arr(float(i))}
        if i in fail_at and i not in failed:
            failed.add(i)
            raise RuntimeError(f"planted failure at {i}")
        return state

    # synchronous saves: the reference looks for the newest checkpoint
    # before it waits for an async save in flight (the port waits first)
    loop = loop_cls(mgr_cls(str(directory), keep=3, async_save=False),
                    ckpt_every=ckpt_every, max_restarts=max_restarts)
    state = start if start is not None else {"sum": arr(0.0)}
    out, diag = loop.run(state, step_fn, n_steps)
    return float(out["sum"]), diag, seen


@pytest.mark.parametrize("fail_at", [(), (3,), (3, 5), (1,)])
def test_restartable_loop_matches_reference(tmp_path, fail_at):
    """Each failure restores the newest verified checkpoint and replays
    from it; a failure before the first checkpoint re-raises.  The port
    replays exactly the reference's steps and ends in its state."""
    runs = {}
    for pkg in ("jax", "port"):
        try:
            total, diag, seen = _counter_run(pkg, tmp_path / pkg, fail_at)
            runs[pkg] = (total, diag["restarts"], seen)   # not the timings
        except RuntimeError as e:
            runs[pkg] = str(e)
    assert runs["port"] == runs["jax"]
    if fail_at == (3,):
        total, restarts, seen = runs["port"]
        assert total == sum(range(7)) and restarts == 1
        assert seen == [0, 1, 2, 3, 2, 3, 4, 5, 6]
    if fail_at == (1,):
        assert runs["port"] == "planted failure at 1"


def test_restartable_loop_resumes_from_a_newer_checkpoint(tmp_path):
    total, _, _ = _counter_run("port", tmp_path, n_steps=4)
    assert total == 6.0
    # a new run over the same directory starts at the checkpoint of step 4
    total, diag, seen = _counter_run("port", tmp_path, n_steps=7)
    assert seen == [4, 5, 6] and total == sum(range(7))
    assert diag["restarts"] == 0


def test_restart_waits_for_a_save_in_flight(tmp_path):
    """A failure right after an async save started restores that save
    (the port waits for the writer before it looks for the newest step)."""
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=3)     # async
    real = mgr._write

    def slow(step, host):
        import time
        time.sleep(0.2)
        real(step, host)

    mgr._write = slow
    loop = ft.RestartableLoop(mgr, ckpt_every=2)
    failed = []

    def step_fn(state, i):
        if i == 2 and not failed:
            failed.append(i)
            raise RuntimeError("planted")
        return {"n": state["n"] + 1}

    state, diag = loop.run({"n": torch.zeros(())}, step_fn, 4)
    assert diag["restarts"] == 1 and float(state["n"]) == 4


def test_restartable_loop_gives_up_after_max_restarts(tmp_path):
    always = set(range(2, 100))

    class Flaky(set):
        def __contains__(self, i):           # fail every time at step 2
            return i in always

        def add(self, i):
            pass

    with pytest.raises(RuntimeError, match="planted"):
        _counter_run("port", tmp_path, fail_at=Flaky(), max_restarts=3)


def test_straggler_monitor_matches_reference():
    times = [1.0] * 10 + [5.0, 1.0, 0.9, 3.0]
    mons = {"jax": jft.StragglerMonitor(), "port": ft.StragglerMonitor()}
    flags = {k: [m.record(i, t) for i, t in enumerate(times)]
             for k, m in mons.items()}
    assert flags["port"] == flags["jax"] and sum(flags["port"]) == 2
    assert mons["port"].events == mons["jax"].events
