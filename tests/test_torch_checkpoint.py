"""Port parity: checkpoints written by either package restore in the other.

The port writes the JAX package's format (npz shards + ``manifest.json``),
its leaves in JAX's flatten order under ``jax.tree_util.keystr`` names, bf16
leaves as the reference writes them (``V2`` bytes, manifest dtype
``bfloat16``).  Restores are exact (bit for bit).  Also a port of the JAX
package's ``TestCheckpoint`` (``test_substrates.py``); the port rejects a
shape mismatch with ValueError where the reference asserts.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import load_checkpoint as jax_load  # noqa: E402
from repro.checkpointing import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.bridge import train_state_from_numpy  # noqa: E402
from repro_torch.checkpointing import (CheckpointManager,  # noqa: E402
                                       latest_step, load_checkpoint,
                                       save_checkpoint)
from repro_torch.tree import leaves_with_path  # noqa: E402


def jax_state(compress):
    """A smoke TrainState a few updates from its init, so m, v, the step
    and the residual are not all zero."""
    cfg = jax_smoke("codeqwen15_7b")
    state = JS.train_state_init(cfg, jax.random.PRNGKey(0),
                                compress=compress)
    step = jax.jit(JS.make_train_step(cfg, warmup_steps=1, compress=compress))
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 9)), jnp.int32)
    for _ in range(2):
        state, _ = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return state


@pytest.mark.parametrize("compress", [False, True])
def test_port_names_its_leaves_as_jax_does(compress):
    js = jax_state(compress)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(js)[0]]
    assert [n for n, _ in leaves_with_path(ts)] == want
    assert ".opt.step" in want and (".residual['embed']" in want) == compress


@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restores_in_jax(tmp_path, compress):
    js = jax_state(compress)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    save_checkpoint(str(tmp_path), 2, ts, shards=3)
    step, back = jax_load(str(tmp_path), js)
    assert step == 2
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("compress", [False, True])
def test_jax_checkpoint_restores_in_port(tmp_path, compress):
    js = jax_state(compress)
    jax_save(str(tmp_path), 2, js, shards=2)
    like = train_state_from_numpy(
        jax.tree.map(lambda t: np.zeros_like(np.asarray(t)), js), "cpu")
    step, back = load_checkpoint(str(tmp_path), like)
    assert step == 2 and type(back) is type(like)
    assert back.opt.step.dtype == torch.int32 and int(back.opt.step) == 2
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bf16_tree():
    bits = np.random.default_rng(0).integers(0, 2**15, (3, 5),
                                             dtype=np.int16)
    t = torch.from_numpy(bits).view(torch.bfloat16)
    return {"w": t, "b": torch.arange(4, dtype=torch.float32)}


def test_bf16_leaf_round_trip(tmp_path):
    tree = _bf16_tree()
    save_checkpoint(str(tmp_path), 1, tree)
    _, back = load_checkpoint(str(tmp_path), tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json")
                          .read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "bfloat16"]


def test_bf16_leaf_is_written_as_jax_writes_it(tmp_path):
    """The same V2 bytes and manifest as the JAX package's save; a JAX
    bf16 checkpoint restores in the port as bf16 (the reference's own
    loader hands back the V2 array)."""
    tree = _bf16_tree()
    jtree = {"w": jnp.asarray(tree["w"].view(torch.int16).numpy()).view(
        jnp.bfloat16), "b": jnp.arange(4, dtype=jnp.float32)}
    save_checkpoint(str(tmp_path / "port"), 1, tree)
    jax_save(str(tmp_path / "jax"), 1, jtree)
    files = [np.load(tmp_path / d / "step_00000001" / "shard0.npz")
             for d in ("port", "jax")]
    for key in ("leaf0", "leaf1"):
        assert files[0][key].dtype == files[1][key].dtype
        assert files[0][key].tobytes() == files[1][key].tobytes()
    assert files[0]["leaf1"].dtype == np.dtype("V2")
    manifests = [json.loads((tmp_path / d / "step_00000001" /
                             "manifest.json").read_text())
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    _, back = load_checkpoint(str(tmp_path / "jax"), tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))


class TestCheckpoint:
    def tree(self):
        return {"params": {"w": torch.arange(12, dtype=torch.float32
                                             ).reshape(3, 4)},
                "step": torch.tensor(7, dtype=torch.int32)}

    def test_roundtrip(self, tmp_path):
        t = self.tree()
        save_checkpoint(str(tmp_path), 5, t, shards=2)
        step, back = load_checkpoint(str(tmp_path), t)
        assert step == 5
        assert torch.equal(back["params"]["w"], t["params"]["w"])

    def test_latest_selected(self, tmp_path):
        t = self.tree()
        assert latest_step(str(tmp_path)) is None
        save_checkpoint(str(tmp_path), 1, t)
        save_checkpoint(str(tmp_path), 2,
                        {"params": {"w": t["params"]["w"] + 1},
                         "step": t["step"] + 1})
        assert latest_step(str(tmp_path)) == 2
        step, back = load_checkpoint(str(tmp_path), t)
        assert step == 2 and int(back["step"]) == 8
        step, back = load_checkpoint(str(tmp_path), t, step=1)
        assert step == 1 and int(back["step"]) == 7

    def test_shape_mismatch_rejected(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, self.tree())
        bad = {"params": {"w": torch.zeros((2, 2))},
               "step": torch.tensor(0, dtype=torch.int32)}
        with pytest.raises(ValueError, match="params"):
            load_checkpoint(str(tmp_path), bad)
        with pytest.raises(ValueError, match="leaves"):
            load_checkpoint(str(tmp_path), {"step": torch.tensor(0)})

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path), self.tree())

    def test_manager_async_and_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        t = self.tree()
        for s in (1, 2, 3):
            mgr.save_async(s, {"params": {"w": t["params"]["w"] + s},
                               "step": t["step"] + s})
        mgr.wait()
        got = mgr.restore_latest(t)
        assert got is not None
        step, back = got
        assert step == 3 and int(back["step"]) == 10
        assert mgr.saved_steps == [1, 2, 3]
        kept = sorted(p for p in os.listdir(tmp_path)
                      if p.startswith("step_"))
        assert kept == ["step_00000002", "step_00000003"]

    def test_manager_copies_before_it_returns(self, tmp_path):
        """The writer saves the values at the call, not later ones."""
        mgr = CheckpointManager(str(tmp_path))
        t = self.tree()
        mgr.save_async(1, t)
        t["params"]["w"].add_(100)
        mgr.wait()
        _, back = load_checkpoint(str(tmp_path), t)
        assert float(back["params"]["w"].max()) == 11.0

    def test_two_writers_at_once(self, tmp_path, monkeypatch):
        """Two threads (``run_training``'s checkpoint apps on two engine
        workers) meet at a barrier and save steps 2 and 4 at once, each
        write slowed by a sleep: after ``wait`` both are on disk, the
        latest is 4 and nothing raised.  Eight rounds, a fresh manager
        each, so an overlap that loses a write shows in some round."""
        import threading
        import time

        from repro_torch.checkpointing import checkpoint as C
        real = C.save_checkpoint

        def slow(*args, **kwargs):
            time.sleep(0.05)
            return real(*args, **kwargs)
        monkeypatch.setattr(C, "save_checkpoint", slow)
        t = self.tree()
        for r in range(8):
            d = tmp_path / f"round{r}"
            mgr = CheckpointManager(str(d))
            barrier = threading.Barrier(2)
            errors = []

            def app(step):
                try:
                    barrier.wait(timeout=30)
                    mgr.save_async(step, t)
                except BaseException as err:   # noqa: BLE001
                    errors.append(err)
            apps = [threading.Thread(target=app, args=(s,)) for s in (2, 4)]
            for a in apps:
                a.start()
            for a in apps:
                a.join(timeout=30)
            mgr.wait()
            assert not errors, errors
            assert sorted(p for p in os.listdir(d)
                          if p.startswith("step_")) == ["step_00000002",
                                                        "step_00000004"]
            assert latest_step(str(d)) == 4
            assert sorted(mgr.saved_steps) == [2, 4]

    def test_manager_writes_in_step_order_and_raises_in_wait(
            self, tmp_path, monkeypatch):
        """Saves handed over while a write runs are written lowest step
        first; a failed write raises from ``wait``, once."""
        import threading

        from repro_torch.checkpointing import checkpoint as C
        real, gate = C.save_checkpoint, threading.Event()

        def gated(directory, step, tree, shards=1):
            gate.wait(timeout=30)
            if step == 9:
                raise OSError("disk full")
            return real(directory, step, tree, shards)
        monkeypatch.setattr(C, "save_checkpoint", gated)
        mgr = CheckpointManager(str(tmp_path), keep=10)
        t = self.tree()
        for s in (1, 5, 3, 9, 2):
            mgr.save_async(s, t)
        gate.set()
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
        mgr.wait()
        assert mgr.saved_steps == [1, 2, 3, 5]
        assert latest_step(str(tmp_path)) == 5

    def test_restore_latest_without_checkpoints(self, tmp_path):
        assert CheckpointManager(str(tmp_path)).restore_latest(
            self.tree()) is None
