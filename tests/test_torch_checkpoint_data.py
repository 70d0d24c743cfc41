"""The port's checkpointing (``repro_torch.checkpoint``) and data pipeline
(``repro_torch.data.pipeline``) on the CPU: the eight cases of
``test_checkpoint_data.py`` rewired to the port, ``packed_batch`` identical
to the reference's, and checkpoints that cross between the packages in both
directions with every bit of every leaf (bf16 included) unchanged."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jpipe
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro_torch import common as tcommon
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.pipeline import (Prefetcher, SyntheticSource, TextFileSource,
                                       packed_batch)
from repro_torch.data.tokenizer import TOKENIZER


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _tree():
    return {"a": {"w": torch.tensor([[1.5, 2.5]], dtype=torch.bfloat16)},
            "b": torch.arange(4, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# the eight cases of test_checkpoint_data.py, on the port
# ---------------------------------------------------------------------------


def test_roundtrip_bf16_and_manifest(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, {"params": _tree()})
    step, out = ckpt.load(d)
    assert step == 3
    assert out["params"]["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["params"]["a"]["w"].float().numpy(), [[1.5, 2.5]])
    np.testing.assert_array_equal(out["params"]["b"].numpy(), np.arange(4))


def test_keep_n_pruning_and_latest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, {"t": {"x": torch.zeros(1)}}, keep=2)
    assert ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]


def test_async_checkpointer_surfaces_errors_and_waits(tmp_path):
    d = str(tmp_path)
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    ac.save(1, {"t": {"x": torch.ones(8)}})
    ac.wait()
    assert ckpt.latest_step(d) == 1
    # error path: unwritable target
    ac2 = ckpt.AsyncCheckpointer("/proc/definitely/not/writable")
    ac2.save(1, {"t": {"x": torch.ones(2)}})
    with pytest.raises(Exception):
        ac2.wait()


def test_atomicity_no_tmp_left_behind(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 7, {"t": {"x": torch.zeros(2)}})
    assert not any(p.endswith(".tmp") for p in os.listdir(d))


def test_packed_batch_deterministic_and_shifted():
    src = SyntheticSource(seed=1)
    b1 = packed_batch(src, 5, batch=3, seq_len=64, seed=9)
    b2 = packed_batch(src, 5, batch=3, seq_len=64, seed=9)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_shards_disjoint_streams():
    src = SyntheticSource(seed=1)
    a = packed_batch(src, 0, batch=2, seq_len=32, shard_id=0, num_shards=2, seed=3)
    b = packed_batch(src, 0, batch=2, seq_len=32, shard_id=1, num_shards=2, seed=3)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_prefetcher_straggler_fallback():
    def make(step):
        return {"tokens": np.full((1, 4), step)}

    pre = Prefetcher(make, depth=2, deadline_s=0.5).start(0)
    try:
        for s in range(4):
            assert pre.get(s)["tokens"][0, 0] == s
    finally:
        pre.stop()
    # asking for a far-future step forces the synchronous straggler path
    pre2 = Prefetcher(make, depth=1, deadline_s=0.2).start(0)
    try:
        assert pre2.get(50)["tokens"][0, 0] == 50
        assert pre2.stragglers == 1
    finally:
        pre2.stop()


def test_textfile_source(tmp_path):
    p = tmp_path / "docs.txt"
    p.write_text("hello world\nsecond doc\n")
    src = TextFileSource(str(p))
    assert TOKENIZER.decode(src.doc_tokens(0)) == "hello world"
    assert packed_batch(src, 0, batch=1, seq_len=16)["tokens"].shape == (1, 16)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,batch,seq_len,shard,shards,seed",
                         [(0, 2, 32, 0, 1, 0), (5, 3, 64, 0, 1, 9), (7, 4, 512, 1, 2, 3),
                          (11, 1, 300, 3, 4, 1)])
def test_packed_batch_identical_to_reference(step, batch, seq_len, shard, shards, seed):
    kw = dict(batch=batch, seq_len=seq_len, shard_id=shard, num_shards=shards, seed=seed)
    got = packed_batch(SyntheticSource(seed=seed, mean_len=96), step, **kw)
    want = jpipe.packed_batch(jpipe.SyntheticSource(seed=seed, mean_len=96), step, **kw)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_textfile_packed_batch_identical_to_reference(tmp_path):
    p = tmp_path / "docs.txt"
    p.write_text("a first document\n\nsecond, longer document with more bytes\nthird é\n")
    got = packed_batch(TextFileSource(str(p)), 2, batch=3, seq_len=40, seed=5)
    want = jpipe.packed_batch(jpipe.TextFileSource(str(p)), 2, batch=3, seq_len=40, seed=5)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _train_trees(seed=0):
    """The reference's params and optimizer state of a smoke MoE model: bf16
    weights, f32 routers and moments, an int32 step."""
    cfg = jconfigs.get_smoke("mixtral-8x22b")
    params = jreg.init_params(cfg, jax.random.PRNGKey(seed))
    state = jopt.init_state(params, jopt.OptimizerConfig())
    state["step"] = jnp.int32(17)
    state["m"] = jax.tree.map(lambda x: x + 0.25, state["m"])
    return {"params": params, "opt_state": state}


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_bits(got_tree, want_tree):
    got, want = jcommon.flatten(got_tree), jcommon.flatten(want_tree)
    assert sorted(got) == sorted(want)
    for p in want:
        g, w = got[p], want[p]
        gd = str(g.dtype).split(".")[-1] if isinstance(g, torch.Tensor) else np.asarray(g).dtype.name
        wd = str(w.dtype).split(".")[-1] if isinstance(w, torch.Tensor) else np.asarray(w).dtype.name
        assert gd == wd, (p, gd, wd)
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, p
        np.testing.assert_array_equal(gb, wb, err_msg=str(p))


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    trees = _train_trees()
    jckpt.save(str(tmp_path), 17, trees, extra_meta={"by": "reference"})
    step, out = ckpt.load(str(tmp_path))
    assert step == 17
    assert out["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert out["opt_state"]["step"].dtype == torch.int32 and int(out["opt_state"]["step"]) == 17
    for name in trees:
        _assert_same_bits(out[name], trees[name])


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    trees = _train_trees(seed=1)
    torch_trees = {n: tcommon.unflatten({p: tcommon._leaf_tensor(np.asarray(v))
                                         for p, v in jcommon.flatten(t).items()})
                   for n, t in trees.items()}
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=1)
    ac.save(17, torch_trees)
    for leaf in tcommon.flatten(torch_trees["params"]).values():
        leaf.zero_()                  # the snapshot was taken before the save returned
    ac.wait()
    step, out = jckpt.load(str(tmp_path))
    assert step == 17
    assert np.asarray(out["params"]["layers"]["attn"]["wq"]).dtype.name == "bfloat16"
    for name in trees:
        _assert_same_bits(out[name], trees[name])
    # and back: the port reads its own file to the same bits
    _, back = ckpt.load(str(tmp_path))
    for name in trees:
        _assert_same_bits(back[name], trees[name])
