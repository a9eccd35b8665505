"""The port's checkpoint store (format v2) and the train-state mapping.

The store's own cases mirror tests/test_checkpoint.py on tensor trees:
bitwise round trips, the file layout, torn writes, per-process meta, v1
dirs.  Then the interop cases, with the JAX package's ``repro.checkpoint``
as the oracle: a train state the port saves loads into JAX's template bit
for bit with JAX's leaf keys, and a state JAX saves loads into the port's
flat storage bit for bit.  Every comparison is exact (no tolerance): the
store copies bits.  Inputs come from explicit numpy seeds.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.comm import init_ef as jax_init_ef
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import (checkpoint_meta, latest_step, leaf_keys,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import (_commit_name, _state_name,
                                               _step_dir, keystr)
from repro_torch.comm import CommConfig
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state, train_state_tree)
from repro_torch.optim import adamw, sgd, warmup_cosine
from repro_torch.weights import leaf_items
from tests.test_torch_train import _jax_cfg, _port_cfg, _tokens

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32),
        "b": torch.tensor(rng.normal(size=(7,)), dtype=torch.bfloat16),
        "count": torch.tensor(rng.integers(0, 100, (2,)), dtype=torch.int32),
        "step": torch.tensor(int(rng.integers(0, 100)), dtype=torch.int32),
    }


def _zeros_like(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


class TestCheckpointV2:
    def test_roundtrip_bitwise(self, tmp_path):
        tree = _tree(0)
        save_checkpoint(str(tmp_path), 5, tree, extra={"total_steps": 20})
        tmpl = _zeros_like(tree)
        out, step = load_checkpoint(str(tmp_path), tmpl)
        assert step == 5 and out is tmpl
        for k in tree:
            assert out[k].dtype == tree[k].dtype
            np.testing.assert_array_equal(_bits(out[k]), _bits(tree[k]))
        meta = checkpoint_meta(str(tmp_path))
        assert meta["extra"]["total_steps"] == 20
        assert meta["bf16"] == ["['b']"]
        assert meta["keys"] == ["['b']", "['count']", "['step']", "['w']"]
        assert meta["treedef"].startswith("repro_torch:")

    def test_strided_leaves_round_trip(self, tmp_path):
        """A leaf that is a view into a (W, N) buffer (an EF leaf) is saved
        and restored in place; the rest of the buffer is untouched."""
        rng = np.random.default_rng(1)
        buf = torch.tensor(rng.normal(size=(3, 40)), dtype=torch.float32)
        tree = {"ef": buf[:, 10:22].view(3, 4, 3), "v": buf[1, 30:]}
        save_checkpoint(str(tmp_path), 1, tree)
        buf2 = torch.full((3, 40), -7.0)
        out, _ = load_checkpoint(str(tmp_path), {
            "ef": buf2[:, 10:22].view(3, 4, 3), "v": buf2[1, 30:]})
        assert torch.equal(buf2[:, 10:22], buf[:, 10:22])
        assert torch.equal(buf2[1, 30:], buf[1, 30:])
        assert bool((buf2[:, :10] == -7.0).all())
        assert bool((buf2[0, 22:] == -7.0).all())

    def test_save_is_atomic_layout(self, tmp_path):
        d = save_checkpoint(str(tmp_path), 3, _tree())
        names = sorted(os.listdir(d))
        assert names == ["commit_0.json", "meta_0.json", "state_0.npz"]
        assert d == _step_dir(str(tmp_path), 3)
        assert os.path.basename(d) == "step_00000003"
        with open(os.path.join(d, "commit_0.json")) as f:
            commit = json.load(f)
        assert commit == {"step": 3, "state_bytes": os.path.getsize(
            os.path.join(d, "state_0.npz"))}
        # an ordinary npz: one .npy entry per leaf, bf16 as uint16 bits
        with np.load(os.path.join(d, "state_0.npz")) as z:
            assert sorted(z.files) == leaf_keys(_tree())
            assert z["['b']"].dtype == np.uint16

    @pytest.mark.parametrize("corruption",
                             ["truncate_npz", "drop_meta", "drop_marker",
                              "drop_npz", "wrong_size_marker",
                              "unreadable_marker"])
    def test_latest_step_skips_torn_write(self, tmp_path, corruption):
        """Whatever part of the newest save is missing or torn, resume
        lands on the previous complete step."""
        tree = _tree(0)
        save_checkpoint(str(tmp_path), 2, tree)
        save_checkpoint(str(tmp_path), 4, _tree(1))
        d4 = _step_dir(str(tmp_path), 4)
        marker = os.path.join(d4, _commit_name(0))
        if corruption == "truncate_npz":
            p = os.path.join(d4, _state_name(0))
            with open(p, "rb+") as f:
                f.truncate(os.path.getsize(p) // 2)
        elif corruption == "drop_meta":
            os.unlink(os.path.join(d4, "meta_0.json"))
        elif corruption == "drop_marker":
            os.unlink(marker)
        elif corruption == "drop_npz":
            os.unlink(os.path.join(d4, _state_name(0)))
        elif corruption == "wrong_size_marker":
            with open(marker) as f:
                commit = json.load(f)
            commit["state_bytes"] += 1
            with open(marker, "w") as f:
                json.dump(commit, f)
        else:
            with open(marker, "w") as f:
                f.write('{"step": 4, "state_')
        assert latest_step(str(tmp_path)) == 2
        out, step = load_checkpoint(str(tmp_path), _zeros_like(tree))
        assert step == 2
        assert torch.equal(out["w"], tree["w"])

    def test_empty_and_all_torn(self, tmp_path):
        assert latest_step(str(tmp_path)) is None
        assert latest_step(str(tmp_path / "missing")) is None
        save_checkpoint(str(tmp_path), 1, _tree())
        os.unlink(os.path.join(_step_dir(str(tmp_path), 1), _commit_name(0)))
        assert latest_step(str(tmp_path)) is None
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path), _tree())
        with pytest.raises(FileNotFoundError):
            checkpoint_meta(str(tmp_path))

    def test_shape_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        bad = _zeros_like(_tree())
        bad["w"] = torch.zeros(3, 4)
        with pytest.raises(ValueError, match="shape mismatch"):
            load_checkpoint(str(tmp_path), bad)

    def test_multi_process_meta_not_clobbered(self, tmp_path):
        """Each process namespaces its state AND meta; completeness is per
        process, and ``process_count`` needs every process complete."""
        t0 = {"only_p0": torch.ones(2)}
        t1 = {"only_p1": torch.zeros(3, 3)}
        save_checkpoint(str(tmp_path), 7, t0, process_index=0)
        save_checkpoint(str(tmp_path), 7, t1, process_index=1)
        save_checkpoint(str(tmp_path), 9, t0, process_index=0)
        m0 = checkpoint_meta(str(tmp_path), step=7, process_index=0)
        m1 = checkpoint_meta(str(tmp_path), process_index=1)
        assert m0["keys"] == ["['only_p0']"]
        assert m1["keys"] == ["['only_p1']"]
        out0, _ = load_checkpoint(str(tmp_path), {"only_p0": torch.zeros(2)},
                                  step=7, process_index=0)
        out1, _ = load_checkpoint(str(tmp_path),
                                  {"only_p1": torch.ones(3, 3)},
                                  process_index=1)
        assert torch.equal(out0["only_p0"], torch.ones(2))
        assert torch.equal(out1["only_p1"], torch.zeros(3, 3))
        # step 9 is complete for process 0 only
        assert latest_step(str(tmp_path), process_index=0) == 9
        assert latest_step(str(tmp_path), process_count=2) == 7
        os.unlink(os.path.join(_step_dir(str(tmp_path), 7),
                               _commit_name(1)))
        assert latest_step(str(tmp_path), process_index=0) == 9
        assert latest_step(str(tmp_path), process_index=1) is None
        assert latest_step(str(tmp_path), process_count=2) is None

    def test_v1_layout_still_readable(self, tmp_path):
        """Old checkpoints (shared meta.json, no marker) load unchanged."""
        w = np.arange(6, dtype=np.float32).reshape(2, 3)
        d = _step_dir(str(tmp_path), 9)
        os.makedirs(d)
        with open(os.path.join(d, "state_0.npz"), "wb") as f:
            np.savez(f, **{"['w']": w})
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"step": 9, "treedef": "PyTreeDef({'w': *})",
                       "bf16": [], "keys": ["['w']"]}, f)
        assert latest_step(str(tmp_path)) == 9
        meta = checkpoint_meta(str(tmp_path))
        assert meta["format"] == 1 and meta["extra"] == {}
        out, step = load_checkpoint(str(tmp_path), {"w": torch.zeros(2, 3)})
        assert step == 9
        np.testing.assert_array_equal(out["w"].numpy(), w)


@pytest.mark.parametrize("path,want", [
    ((0, "body", 0, "ffn", "down", "w"), "[0]['body'][0]['ffn']['down']['w']"),
    ((1, "count"), "[1]['count']"),
    ((1, "mu", "embed", "table"), "[1]['mu']['embed']['table']"),
    ((2, "final_norm", "scale"), "[2]['final_norm']['scale']")])
def test_keystr_matches_jax(path, want):
    jpath = tuple(jax.tree_util.SequenceKey(p) if isinstance(p, int)
                  else jax.tree_util.DictKey(p) for p in path)
    assert keystr(path) == want == jax.tree_util.keystr(jpath)


# ---------------------------------------------------------------------------
# the train state against the JAX package's checkpoint tree
# ---------------------------------------------------------------------------

W = 3
OPTS = {"adamw": (adamw, jadamw), "sgd": (lambda: sgd(momentum=0.9),
                                          lambda: jsgd(momentum=0.9))}


def _jax_template(opt_name: str, ef: bool):
    """The JAX launcher's checkpoint tree for the reduced smollm."""
    params = jtransformer.init_params(jax.random.PRNGKey(0), _jax_cfg(True))
    opt_state = OPTS[opt_name][1]().init(params)
    if ef:
        return params, opt_state, jax_init_ef(params, W)
    return params, opt_state


def _filled_port_state(opt_name: str, ef: bool, seed: int):
    """A reduced port train state with every entry random (no zeros)."""
    comm = CommConfig(codec="signsgd" if ef else "none")
    state = init_train_state(_port_cfg(True), OPTS[opt_name][0](), seed=0,
                             comm=comm, workers=W)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        state.flat.copy_(torch.tensor(rng.normal(size=state.flat.shape)))
        for k, v in state.opt_state.items():
            v.copy_(torch.tensor(rng.normal(size=v.shape)) if v.dim()
                    else torch.tensor(int(rng.integers(1, 1000))))
        if ef:
            state.ef.copy_(torch.tensor(rng.normal(size=state.ef.shape)))
    return state


def _jax_keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("ef", [False, True], ids=["no_ef", "ef"])
def test_port_save_loads_in_jax(tmp_path, opt_name, ef):
    """The port saves its train state; JAX's load_checkpoint fills a JAX
    template from it bit for bit, and the meta's keys are JAX's."""
    state = _filled_port_state(opt_name, ef, seed=11)
    tree = train_state_tree(state)
    save_checkpoint(str(tmp_path), 5, tree, extra={"total_steps": 9})
    template = _jax_template(opt_name, ef)
    want_keys = sorted(_jax_keyed(template))
    assert checkpoint_meta(str(tmp_path))["keys"] == want_keys
    assert leaf_keys(tree) == want_keys
    out, step = jax_load(str(tmp_path), template)
    assert step == 5
    got = _jax_keyed(out)
    port = {keystr(p): leaf for p, leaf in leaf_items(tree)}
    assert sorted(port) == sorted(got)
    for k, leaf in port.items():
        assert got[k].dtype == _bits(leaf).dtype, k
        np.testing.assert_array_equal(got[k], _bits(leaf), err_msg=k)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("ef", [False, True], ids=["no_ef", "ef"])
def test_jax_save_loads_in_port(tmp_path, opt_name, ef):
    """JAX saves a random state in its layout; the port restores it into
    its flat storage, and every entry of flat, mu, nu, count and ef is the
    JAX leaf's, in canonical order."""
    template = _jax_template(opt_name, ef)
    rng = np.random.default_rng(12)
    leaves, treedef = jax.tree.flatten(template)
    filled = jax.tree.unflatten(treedef, [
        jnp.asarray(rng.integers(1, 1000, x.shape), x.dtype)
        if x.dtype == jnp.int32 else
        jnp.asarray(rng.normal(size=x.shape), x.dtype) for x in leaves])
    jax_save(str(tmp_path), 3, filled)
    state = init_train_state(_port_cfg(True), OPTS[opt_name][0](), seed=5,
                             comm=CommConfig(codec="signsgd" if ef
                                             else "none"), workers=W)
    ptrs = {"flat": state.flat.data_ptr(),
            **{k: v.data_ptr() for k, v in state.opt_state.items()}}
    _, step = load_checkpoint(str(tmp_path), train_state_tree(state))
    assert step == 3
    # restored in place: the same storage
    assert state.flat.data_ptr() == ptrs["flat"]
    assert all(state.opt_state[k].data_ptr() == p for k, p in ptrs.items()
               if k != "flat")

    def flat_of(tree, lead=0):
        xs = [np.asarray(x) for x in jax.tree.leaves(tree)]
        if lead:
            return np.concatenate([x.reshape(lead, -1) for x in xs], axis=1)
        return np.concatenate([x.reshape(-1) for x in xs])

    np.testing.assert_array_equal(state.flat.numpy(), flat_of(filled[0]))
    jopt = filled[1]
    for k in ("mu", "nu"):
        if k in jopt:
            np.testing.assert_array_equal(state.opt_state[k].numpy(),
                                          flat_of(jopt[k]))
    assert sorted(state.opt_state) == sorted(jopt)
    if "count" in jopt:
        assert state.opt_state["count"].dtype == torch.int32
        assert int(state.opt_state["count"]) == int(jopt["count"])
    if ef:
        np.testing.assert_array_equal(state.ef.numpy(),
                                      flat_of(filled[2], lead=W))


def test_restore_keeps_parameter_leaves_on_the_flat_vector(tmp_path):
    """After a restore every parameter leaf (an autograd leaf) still shares
    storage with ``state.flat`` and holds the restored weights, and a step
    taken after it moves them: a restore that rebound ``flat`` would leave
    the leaves on the old weights."""
    src = _filled_port_state("sgd", False, seed=21)
    save_checkpoint(str(tmp_path), 2, train_state_tree(src))
    state = init_train_state(_port_cfg(True), sgd(momentum=0.9), seed=0)
    load_checkpoint(str(tmp_path), train_state_tree(state))
    lo = state.flat.data_ptr()
    hi = lo + state.flat.numel() * state.flat.element_size()
    leaves = [t for _, t in leaf_items(state.params)]
    for t, o, n in zip(leaves, state.layout.offsets, state.layout.sizes):
        assert t.requires_grad and lo <= t.data_ptr() < hi
        assert torch.equal(t.detach().reshape(-1), src.flat[o:o + n])
    before = [t.detach().clone() for t in leaves]
    step = build_train_step(
        _port_cfg(True), TrainConfig(aggregator=AggregatorConfig("mean")),
        sgd(momentum=0.9), warmup_cosine(0.05, 8, 1))
    batch = {k: torch.from_numpy(v) for k, v in
             _tokens(3, (2, 2), 16).items()}
    step(state, batch, 2)
    for t, b, o, n in zip(leaves, before, state.layout.offsets,
                          state.layout.sizes):
        assert torch.equal(t.detach().reshape(-1), state.flat[o:o + n])
    assert any(not torch.equal(t.detach(), b) for t, b in zip(leaves, before))
