"""The port's checkpointer (``repro_torch.checkpoint``) on the CPU: the
reference's own cases (``tests/test_checkpoint.py``) on torch trees, and
the shared on-disk format against the JAX package's ``Checkpointer``: a
reference ``TrainState`` checkpoint (reduced gemma-2b in bf16, gradient
compression on, after one step) restores into the port's state, the
port's restores into the reference's, leaf for leaf and bit for bit, and
``save_async`` keeps the state as it was when it returned even though the
next step updates it in place."""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt_mod  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "gemma-2b"
SEQ, BATCH = 16, 2


def tree():
    return {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                  "b16": torch.ones(4, dtype=torch.bfloat16) * 1.5},
            "step_arr": torch.tensor(7, dtype=torch.int32)}


def _leaves(t):
    return dict(ckpt_mod._leaves(t))


def test_roundtrip_keeps_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = tree()
    ck.save(10, t, metadata={"data_step": 10})
    like = {"a": {"w": torch.zeros(2, 3), "b16": torch.zeros(
        4, dtype=torch.bfloat16)}, "step_arr": torch.tensor(0, dtype=torch.int32)}
    restored, manifest = ck.restore(like)
    assert restored is like
    assert manifest["step"] == 10 and manifest["metadata"] == {"data_step": 10}
    assert manifest["dtypes"] == {"a/w": "float32", "a/b16": "bfloat16",
                                  "step_arr": "int32"}
    for name, leaf in _leaves(t).items():
        got = _leaves(restored)[name]
        assert got.dtype == leaf.dtype
        assert torch.equal(got, leaf), name


def test_keep_k_garbage_collection(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        ck.save(s, tree())
    assert ck.all_steps() == [3, 4]


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(5, tree())
    ck.wait()
    assert ck.all_steps() == [5]


def test_corruption_falls_back_to_previous(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    t = tree()
    ck.save(1, t)
    t2 = tree()
    t2["a"]["w"] += 1
    t2["step_arr"] += 1
    ck.save(2, t2)
    npz = os.path.join(str(tmp_path), "step_0000000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(30)
        f.write(b"\xde\xad")
    like = tree()
    like["a"]["w"].zero_()
    restored, manifest = ck.restore(like)
    assert manifest["step"] == 1            # fell back
    assert torch.equal(restored["a"]["w"], t["a"]["w"])
    with pytest.raises(IOError, match="integrity"):
        ck._load_step(2)


def test_atomic_partial_write_invisible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree())
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp-partial"))
    assert ck.all_steps() == [1]


def test_missing_dir_raises(tmp_path):
    ck = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ck.restore(tree())


def test_restore_holds_names_shapes_and_dtypes(tmp_path):
    """A leaf the checkpoint lacks, or one of another shape or dtype,
    raises and names the leaf."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree())
    with pytest.raises(KeyError, match="a/extra"):
        ck.restore({"a": {"extra": torch.zeros(1)}})
    with pytest.raises(ValueError, match="a/w"):
        ck.restore({"a": {"w": torch.zeros(3, 2)}})
    with pytest.raises(ValueError, match="a/b16"):
        ck.restore({"a": {"b16": torch.zeros(4)}})


@pytest.fixture(scope="module")
def states():
    """One compressed reference step on reduced gemma-2b in bf16, and the
    port's state around the same starting parameters."""
    cfg = get_config(ARCH, reduced=True).with_(dtype="bfloat16")
    comp = jcomp.CompressionConfig(enabled=True, block_size=64)
    state, _ = jts.init_state(cfg, jax.random.PRNGKey(0), comp)
    batch = JSyntheticLM(JPipelineConfig(cfg.vocab_size, SEQ, BATCH)
                         ).global_batch(0)
    stepped, _ = jax.jit(jts.make_train_step(cfg, comp=comp))(
        state, jax.tree.map(jnp.asarray, batch))
    tcfg = port_config(ARCH, reduced=True).with_(dtype="bfloat16")
    return cfg, state, stepped, tcfg, batch


def _port_state(tcfg, jparams):
    params = params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
        device="cpu", dtype=torch.bfloat16, trainable=True)
    return ts.init_state(tcfg, params, "cpu",
                         compression.CompressionConfig(True, 64))


def _as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32) if str(x.dtype).endswith("bfloat16") \
        else np.asarray(x)


def test_state_leaf_names_are_the_references(states):
    """The port's ``TrainState`` flattens to the reference's 52 leaf names
    (parameters, AdamW's step, masters, m and v, the error state and the
    step) with the same shapes and dtype tags."""
    cfg, state, _, tcfg, _ = states
    ours = ckpt_mod._flatten(_port_state(tcfg, state.params))
    theirs = jckpt._flatten(state)
    assert len(ours) == 52
    assert ours.keys() == theirs.keys()
    for k, (arr, tag) in ours.items():
        safe, want_tag = jckpt._np_safe(theirs[k])
        assert tag == want_tag, k
        assert arr.shape == safe.shape and arr.dtype == safe.dtype, k


def test_reference_checkpoint_restores_into_the_port(states, tmp_path):
    """The reference's checkpoint of its stepped state restores into the
    port's state, in place, every leaf equal bit for bit to the
    reference's (the parameters to ``params_from_numpy`` of them)."""
    cfg, state, stepped, tcfg, _ = states
    JCheckpointer(str(tmp_path)).save(1, stepped, metadata={"data_step": 1})
    like = _port_state(tcfg, state.params)
    wq = like.params["layers"]["attn"]["wq"]
    master = like.opt.master["layers.attn.wq"]
    restored, manifest = Checkpointer(str(tmp_path)).restore(like)
    assert manifest["metadata"] == {"data_step": 1}
    assert restored.params["layers"]["attn"]["wq"] is wq
    assert restored.opt.master["layers.attn.wq"] is master
    want_params = params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), stepped.params),
        device="cpu", dtype=torch.bfloat16)
    for name, p in want_params.named_parameters():
        got = dict(restored.params.named_parameters())[name]
        assert torch.equal(got.detach(), p.detach()), name
    theirs = jckpt._flatten(stepped)
    for name, leaf in ckpt_mod._leaves(restored):
        np.testing.assert_array_equal(_as_f32(leaf.detach()),
                                      _as_f32(theirs[name]), err_msg=name)
    assert int(restored.step) == int(restored.opt.step) == 1
    assert any(bool(e.abs().max() > 0) for e in restored.err_fb.values())


def test_port_checkpoint_restores_into_the_reference(states, tmp_path):
    """One port step's state, saved by the port, restores through the
    reference's ``Checkpointer.restore(like=...)`` leaf for leaf and bit
    for bit."""
    cfg, state, _, tcfg, batch = states
    tstate = _port_state(tcfg, state.params)
    tstep = ts.make_train_step(tcfg, comp=compression.CompressionConfig(
        True, 64))
    tstate, _ = tstep(tstate, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    Checkpointer(str(tmp_path)).save(1, tstate, metadata={"data_step": 1})
    with open(os.path.join(str(tmp_path), "step_0000000001",
                           "manifest.json")) as f:
        assert json.load(f)["dtypes"]["params/layers/attn/wq"] == "bfloat16"
    restored, manifest = JCheckpointer(str(tmp_path)).restore(state)
    assert manifest["step"] == 1
    theirs = jckpt._flatten(restored)
    ours = dict(ckpt_mod._leaves(tstate))
    assert ours.keys() == theirs.keys()
    for name, leaf in ours.items():
        assert str(theirs[name].dtype) == str(leaf.dtype).removeprefix(
            "torch."), name
        np.testing.assert_array_equal(_as_f32(theirs[name]),
                                      _as_f32(leaf.detach()), err_msg=name)


def test_save_async_snapshots_before_an_in_place_step(states, tmp_path):
    """``save_async`` returns with the state copied to the host: the next
    step, which updates every parameter, master, m, v and error leaf in
    place, does not reach the file."""
    cfg, state, _, tcfg, batch = states
    comp = compression.CompressionConfig(True, 64)
    tstate = _port_state(tcfg, state.params)
    tstep = ts.make_train_step(tcfg, comp=comp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tstate, _ = tstep(tstate, tb)
    at_save = {k: v.detach().clone() for k, v in ckpt_mod._leaves(tstate)}
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, tstate)
    tstate, _ = tstep(tstate, tb)
    ck.wait()
    moved = sum(not torch.equal(v.detach(), at_save[k])
                for k, v in ckpt_mod._leaves(tstate))
    assert moved >= 40
    like = _port_state(tcfg, state.params)
    restored, _ = ck.restore(like)
    for name, leaf in ckpt_mod._leaves(restored):
        assert torch.equal(leaf.detach(), at_save[name]), name
