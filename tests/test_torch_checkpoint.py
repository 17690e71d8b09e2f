"""The port's checkpoints (``gofr_tpu_torch/utils/checkpoint.py``) in the
JAX package's format, on the CPU:

- a whole JAX ``TrainState`` (``tiny``, float32) saved by
  ``gofr_tpu.utils.save_checkpoint`` after two JAX steps restores in the
  port into a state of its own structure and takes the next step as JAX
  takes it from the same state (loss within 1e-6 relative; params within
  1e-5 where the first moment is above 1e-2 of its leaf's largest, 2·lr
  elsewhere: ``test_torch_train.py`` says why; the moments come from
  JAX's steps, so only the last step's can flip a sign);
- a port ``TrainState`` at bfloat16 restores in
  ``gofr_tpu.utils.restore_checkpoint`` leaf for leaf, bits and dtypes
  equal, and its ``tree.json`` holds the keys, treedef and dtypes JAX
  writes for the same state;
- the port's own cases, JAX's ``tests/test_checkpoint.py`` cases as
  parameters: round trip with metadata, latest-step resolution, an
  overwrite, the ``step_N.old`` crash window;
- a bfloat16 restore in a process where ``ml_dtypes`` cannot be
  imported, of a checkpoint JAX wrote.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import make_train_step as jax_make_train_step
from gofr_tpu.utils import restore_checkpoint as jax_restore
from gofr_tpu.utils import save_checkpoint as jax_save
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_train_state
from gofr_tpu_torch.parallel import make_train_step
from gofr_tpu_torch.utils import (checkpoint_metadata, latest_step,
                                  restore_checkpoint, save_checkpoint)
from gofr_tpu_torch.utils import tree as tree_util

ROOT = Path(__file__).resolve().parents[1]
LR = 3e-4


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (2, 16))
    return tokens, np.roll(tokens, -1, axis=1)


def _bits(leaf):
    """A leaf's raw bytes and dtype name, torch or numpy/JAX alike."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        name = str(leaf.dtype).replace("torch.", "")
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy().tobytes(), name
    leaf = np.asarray(leaf)
    return leaf.tobytes(), str(leaf.dtype)


def test_jax_train_state_restores_and_continues(tmp_path):
    jcfg = jax_llama.config("tiny", dtype=jnp.float32)
    pcfg = pt_llama.config("tiny", dtype=torch.float32)
    init_fn, step_fn = jax_make_train_step(jcfg, make_mesh({"dp": 1}))
    state = init_fn(jax.random.PRNGKey(0))
    tokens, targets = _batch(jcfg.vocab_size, 1)
    for _ in range(2):
        state, _ = step_fn(state, jnp.asarray(tokens), jnp.asarray(targets))
    jax_save(str(tmp_path), state, step=2, metadata={"preset": "tiny"})
    saved = jax.tree.map(np.asarray, state)
    state, jloss = step_fn(state, jnp.asarray(tokens), jnp.asarray(targets))
    after = jax.tree.map(np.asarray, state)

    pinit, pstep = make_train_step(pcfg, learning_rate=LR, device="cpu")
    fresh = pinit(7)
    restored = restore_checkpoint(str(tmp_path), fresh, device="cpu")
    assert checkpoint_metadata(str(tmp_path))["metadata"] == {
        "preset": "tiny"}
    got, want = tree_util.flatten(restored), tree_util.flatten(saved)
    assert list(got) == list(want) and len(got) == 38
    for key in want:
        assert _bits(got[key]) == _bits(want[key]), key
    # the same structure as the converter's
    assert tree_util.treedef(restored) == tree_util.treedef(
        from_jax_train_state(saved, "cpu"))

    restored, ploss = pstep(restored, tokens, targets)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-6)
    assert int(restored.step) == int(after.step) == 3
    mu = tree_util.flatten(after.opt_state[0].mu)
    got = tree_util.flatten(restored.params)
    for key, ref in tree_util.flatten(after.params).items():
        delta = np.abs(got[key].numpy() - ref)
        settled = np.abs(mu[key]) > 1e-2 * np.abs(mu[key]).max()
        assert delta[settled].max() <= 1e-5, key
        assert delta.max() <= 2 * LR, key


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A bf16 port state after one step: JAX's restore gives every leaf's
    bits and dtype, and the port's ``tree.json`` and stored arrays are
    the ones JAX writes for that state."""
    pcfg = pt_llama.config("tiny")
    jcfg = jax_llama.config("tiny")
    pinit, pstep = make_train_step(pcfg, device="cpu")
    state = pinit(3)
    tokens, targets = _batch(pcfg.vocab_size, 2)
    state, _ = pstep(state, tokens, targets)
    assert state.params["lm_head"].dtype == torch.bfloat16
    save_checkpoint(str(tmp_path / "port"), state, step=1,
                    metadata={"from": "port"})
    jinit, _ = jax_make_train_step(jcfg, make_mesh({"dp": 1}))
    like = jinit(jax.random.PRNGKey(0))
    restored = jax_restore(str(tmp_path / "port"), like)
    got, want = tree_util.flatten(restored), tree_util.flatten(state)
    assert list(got) == list(want)
    for key in want:
        assert _bits(got[key]) == _bits(want[key]), key
    jax_save(str(tmp_path / "jax"), restored, step=1,
             metadata={"from": "port"})
    ours = json.loads((tmp_path / "port/step_1/tree.json").read_text())
    theirs = json.loads((tmp_path / "jax/step_1/tree.json").read_text())
    assert ours == theirs
    # the same bytes under each name; a bf16 leaf is uint16 words in the
    # port's file, and in JAX's wherever numpy does not know the name
    # "bfloat16" (where ml_dtypes registered it, JAX stores 2-byte void
    # records: its restore views either, and so does the port's)
    with np.load(tmp_path / "port/step_1/arrays.npz") as a, \
            np.load(tmp_path / "jax/step_1/arrays.npz") as b:
        assert a.files == b.files
        for name in a.files:
            assert a[name].shape == b[name].shape, name
            assert a[name].tobytes() == b[name].tobytes(), name
            if ours["dtypes"][name] == "bfloat16":
                assert a[name].dtype == np.uint16
                assert b[name].dtype in (np.uint16, np.dtype("V2"))
            else:
                assert a[name].dtype == b[name].dtype, name


def _case_round_trip(tmp_path):
    params = pt_llama.init(pt_llama.config("tiny"), 0, device="cpu")
    path = save_checkpoint(str(tmp_path), params, step=3,
                           metadata={"preset": "tiny"})
    assert path.endswith("step_3")
    restored = restore_checkpoint(str(tmp_path), params, device="cpu")
    for key, leaf in tree_util.flatten(params).items():
        back = tree_util.flatten(restored)[key]
        assert back.dtype == leaf.dtype == torch.bfloat16
        assert torch.equal(back, leaf)
    meta = checkpoint_metadata(str(tmp_path))
    assert meta["step"] == 3 and meta["metadata"]["preset"] == "tiny"
    # a like of another dtype (or on the meta device) casts, as JAX's
    like = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in tree_util.flatten(params).items()}
    cast = restore_checkpoint(str(tmp_path), tree_util.unflatten(
        params, like), device="cpu")
    assert torch.equal(cast["lm_head"], params["lm_head"].float())


def _case_latest_step(tmp_path):
    tree = {"w": torch.ones((2,))}
    assert latest_step(str(tmp_path)) is None
    for step in (1, 10, 2):
        save_checkpoint(str(tmp_path), tree, step=step)
    assert latest_step(str(tmp_path)) == 10
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), tree, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), {"v": torch.ones((2,))},
                           device="cpu")


def _case_overwrite(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), tree, step=3)
    path = save_checkpoint(str(tmp_path), {"w": tree["w"] * 7}, step=3)
    assert os.path.isdir(path)
    out = restore_checkpoint(str(tmp_path), tree, step=3, device="cpu")
    assert torch.equal(out["w"], tree["w"] * 7)
    assert sorted(os.listdir(tmp_path)) == ["step_3"]


def _case_crash_window(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), tree, step=5)
    os.rename(tmp_path / "step_5", tmp_path / "step_5.old")
    assert latest_step(str(tmp_path)) == 5
    out = restore_checkpoint(str(tmp_path), tree, step=5, device="cpu")
    assert torch.equal(out["w"], tree["w"])
    assert checkpoint_metadata(str(tmp_path))["step"] == 5
    save_checkpoint(str(tmp_path), {"w": tree["w"] + 1}, step=5)
    out = restore_checkpoint(str(tmp_path), tree, step=5, device="cpu")
    assert torch.equal(out["w"], tree["w"] + 1)
    assert sorted(os.listdir(tmp_path)) == ["step_5"]


@pytest.mark.parametrize("case", [_case_round_trip, _case_latest_step,
                                  _case_overwrite, _case_crash_window],
                         ids=["round_trip", "latest_step", "overwrite",
                              "crash_window"])
def test_port_checkpoint_cases(tmp_path, case):
    case(tmp_path)


def test_bf16_restore_without_ml_dtypes(tmp_path):
    """JAX writes a bf16 tree; in a process where ``ml_dtypes`` cannot be
    imported, the port restores it by a view of the stored words (the
    same bits, no numeric cast), then writes and reads it back."""
    rng = np.random.default_rng(4)
    tree = {"a": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
            "b": (jnp.arange(4, dtype=jnp.int32),)}
    jax_save(str(tmp_path), tree, step=1)
    words = np.asarray(tree["a"]).view(np.uint16)
    np.save(tmp_path / "words.npy", words)
    script = f"""
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
from gofr_tpu_torch.utils import restore_checkpoint, save_checkpoint
try:
    import ml_dtypes
    raise SystemExit("ml_dtypes importable")
except ImportError:
    pass
d = {str(tmp_path)!r}
like = {{"a": torch.empty((3, 5), dtype=torch.bfloat16),
        "b": (torch.empty((4,), dtype=torch.int32),)}}
out = restore_checkpoint(d, like, device="cpu")
want = torch.from_numpy(np.load(d + "/words.npy").view(np.int16))
assert out["a"].dtype == torch.bfloat16
assert torch.equal(out["a"].view(torch.int16), want)
assert out["b"][0].tolist() == [0, 1, 2, 3]
save_checkpoint(d, out, step=2)
again = restore_checkpoint(d, like, device="cpu")
assert torch.equal(again["a"].view(torch.int16), want)
assert "ml_dtypes" not in {{m for m in sys.modules if sys.modules[m]}}
print("ok")
"""
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "ok"
    # and JAX reads what the port wrote there
    back = jax_restore(str(tmp_path), tree, step=2)
    assert back["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"]).view(np.uint16),
                                  words)
