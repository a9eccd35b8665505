"""repro_torch.analysis: the port's invariant checks, rule by rule.

Each test of the JAX package's ``tests/test_analysis.py`` outside its sweep
has a torch twin here with the same expected verdict (rule family and op
class): one true positive and one true negative a rule family.  Where
JAX's rule runs on this machine (the HLO-level SHAPE cases,
``full_width_dims``, COLLECTIVES, RECOMPILE, MASK's python-branch, the
contract's on/off plumbing), the twin runs JAX's rule beside its own and
holds the two verdicts equal; elsewhere the expected verdict is the one
JAX's test asserts.  A bf16 ``mm`` is no finding in torch (cuBLAS and
the CPU kernels accumulate in fp32), so the PRECISION twins of JAX's
bf16 ``dot_general`` cases are a contraction with a bf16 accumulator
(``addmm``), a bf16 sum across ranks and a bf16 buffer accumulated in
place.  The kernel-mutant classes become seeded CUDA-source and ptxas-log
mutants for KSENTINEL and KBUDGET, each with a clean case.  Inputs come
from numpy with explicit per-test seeds; exact verdicts, no tolerances,
except the KSENTINEL cases, held bit for bit (NaN equal to NaN).
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.analysis as A
from repro_torch.analysis import kernel_rules as K
from repro_torch.analysis.trace import Trace, _Checks
from repro_torch.launch.dryrun import fake_world

BF = torch.bfloat16
# the module (the package's ``contract`` name is the decorator)
contract_mod = importlib.import_module("repro_torch.analysis.contract")
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _bf16_mats(m=4, k=8, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                             ).to(BF),
            torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                             ).to(BF))


def _jax():
    import jax
    import jax.numpy as jnp

    import repro.analysis as JA
    return jax, jnp, JA


# ---------------------------------------------------------------------------
# SHAPE
# ---------------------------------------------------------------------------

class TestShapeRule:
    def test_max_dim_true_positive(self):
        t = A.capture(lambda a: a @ a.T, torch.ones(3, 5))
        findings = A.check_shape(t, max_dim=4)
        assert findings and all(f.rule == "shape" for f in findings)

    def test_max_dim_true_negative(self):
        t = A.capture(lambda a: a @ a.T, torch.ones(3, 5))
        assert A.check_shape(t, max_dim=5) == []

    def test_forbidden_and_required(self):
        jax, jnp, JA = _jax()
        hlo = jax.jit(lambda a: a.sum(0)).lower(
            jnp.ones((4, 16))).compile().as_text()
        g = JA.Graph("sum", None, hlo)
        t = A.capture(lambda a: a.sum(0), torch.ones(4, 16))
        for rule, graph in ((A.check_shape, t), (JA.check_shape, g)):
            assert rule(graph, forbidden_dims={16}, require_dims={16})
            assert rule(graph, forbidden_dims={999},
                        require_dims={16}) == []

    def test_required_dims_absent_is_a_finding(self):
        jax, jnp, JA = _jax()
        verdicts = []
        for findings in (
                A.check_shape(A.capture(lambda a: a * 2, torch.ones(4)),
                              require_dims={777}),
                JA.check_shape(JA.capture(lambda a: a * 2, jnp.ones((4,)),
                                          compile=True),
                               require_dims={777})):
            verdicts.append((len(findings), "required" in
                             findings[0].message, findings[0].op))
        assert verdicts[0] == verdicts[1] == (1, True, "<absent>")

    def test_full_width_dims_derivation(self):
        _, jnp, JA = _jax()
        tree = {"a": torch.zeros(8, 1024), "b": torch.zeros(8, 256, 2)}
        forbidden, required = A.full_width_dims(tree, 8)
        assert {1024, 512, 256, 1536} <= forbidden
        assert {128, 64, 32} <= required
        assert not (forbidden & required)
        jtree = {"a": jnp.zeros((8, 1024)), "b": jnp.zeros((8, 256, 2))}
        assert (forbidden, required) == JA.full_width_dims(jtree, 8)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_full_width_dims_equals_jax_on_seeded_trees(self, seed):
        _, jnp, JA = _jax()
        rng = np.random.default_rng(seed)
        shards = int(rng.choice([2, 4, 8]))
        shapes = [(8,) + tuple(int(d) for d in rng.choice(
            [1, 2, 3, 16, 24, 64, 96, 256], size=rng.integers(1, 3)))
            for _ in range(int(rng.integers(1, 5)))]
        tree = {f"l{i}": torch.zeros(s) for i, s in enumerate(shapes)}
        jtree = {f"l{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
        assert A.full_width_dims(tree, shards) == \
            JA.full_width_dims(jtree, shards)

    def test_needs_a_graph(self):
        _, _, JA = _jax()
        with pytest.raises(ValueError):
            A.check_shape(Trace("empty"), max_dim=1)
        with pytest.raises(ValueError):
            JA.check_shape(JA.Graph("empty"), max_dim=1)


# ---------------------------------------------------------------------------
# PRECISION
# ---------------------------------------------------------------------------

class TestPrecisionRule:
    def test_bf16_contraction_true_positive(self):
        """A contraction with a bf16 accumulator (JAX: a bf16 dot)."""
        x, w = _bf16_mats()
        acc = torch.zeros(4, 4, dtype=BF)
        t = A.capture(lambda c, a, b: torch.addmm(c, a, b), acc, x, w)
        findings = A.check_precision(t)
        assert findings and findings[0].op == "aten.addmm.default"

    def test_fp32_accumulated_contraction_true_negative(self):
        from repro_torch.models import layers
        x, w = _bf16_mats()
        t = A.capture(lambda a, b: layers.product_f32(a, b).to(BF), x, w)
        assert A.check_precision(t) == []

    def test_bf16_cross_rank_sum_true_positive(self):
        """The TP fault's class: partials summed over ranks in bf16."""
        from repro_torch.dist.sharded import all_reduce_
        x, _ = _bf16_mats()
        with fake_world(2):
            bad = A.capture(lambda a: all_reduce_(a.clone(), "tp_reduce"), x)
            good = A.capture(lambda a: all_reduce_(a.float(), "tp_reduce")
                             .to(BF), x)
            peak = A.capture(lambda a: all_reduce_(
                a.clone(), "tp_loss", torch.distributed.ReduceOp.MAX), x)
        findings = A.check_precision(bad)
        assert [f.op for f in findings] == ["tp_reduce"]
        assert A.check_precision(good) == []
        assert A.check_precision(peak) == []      # a max is exact

    def test_bf16_accumulating_ops_true_positive(self):
        x, _ = _bf16_mats()
        assert A.check_precision(A.capture(
            lambda a: torch.cumsum(a, dim=0), x))
        idx = torch.tensor([0, 1, 0, 1])
        assert A.check_precision(A.capture(
            lambda a: torch.zeros(2, 8, dtype=BF).index_add_(0, idx, a), x))
        assert A.check_precision(A.capture(
            lambda a: torch.zeros(2, 8, dtype=BF).index_put_(
                (idx,), a, accumulate=True), x))

    def test_default_sum_true_negative(self):
        """torch's sum accumulates bf16 in fp32: not flagged."""
        x, _ = _bf16_mats()
        assert A.check_precision(A.capture(lambda a: a.sum(0), x)) == []

    def test_fp32_graph_never_flags(self):
        t = A.capture(lambda a: (a @ a.T).sum().cumsum(0), torch.ones(6, 6))
        assert A.check_precision(t) == []

    def test_sees_through_loops_and_nesting(self):
        """A bf16 buffer added into in place, inside a loop of a nested
        function (JAX: through jit and scan)."""
        x, _ = _bf16_mats()

        def inner(acc, a):
            for _ in range(3):
                acc.add_(a)
            return acc
        t = A.capture(lambda a: inner(torch.zeros_like(a), a), x)
        findings = A.check_precision(t)
        assert len(findings) == 1 and findings[0].op == "aten.add_.Tensor"
        t32 = A.capture(lambda a: inner(torch.zeros_like(a), a), x.float())
        assert A.check_precision(t32) == []

    def test_allowed_site_is_skipped_and_counted(self):
        x, _ = _bf16_mats()

        def exact(a):
            with A.allowed("precision", "test: exact"):
                return torch.cumsum(a, dim=0)
        t = A.capture(exact, x)
        assert A.check_precision(t) == []
        assert [k[:2] for k in t.allowed] == [("precision", "test: exact")]
        assert list(t.allowed.values()) == [1]


# ---------------------------------------------------------------------------
# TRANSFER
# ---------------------------------------------------------------------------

class TestTransferRule:
    def test_host_read_true_positive(self):
        """``.item()`` (JAX: ``pure_callback``)."""
        t = A.capture(lambda x: x * x.sum().item(), torch.ones(4))
        findings = A.check_transfer(t)
        assert findings and "_local_scalar_dense" in findings[0].op

    @pytest.mark.parametrize("fn", [
        lambda x: bool((x > 0).any()),
        lambda x: torch.nonzero(x),
        lambda x: torch.linalg.cholesky(x[:2, None] * x[None, :2] + 1),
        lambda x: torch.unique(x),
        lambda x: torch.repeat_interleave(x, torch.tensor([1, 2, 1, 1]))])
    def test_host_reads_true_positive(self, fn):
        assert A.check_transfer(A.capture(fn, torch.ones(4)))

    def test_clean_graph_true_negative(self):
        t = A.capture(lambda x: torch.sin(x).sum(), torch.ones(4))
        assert A.check_transfer(t) == []

    def test_literal_is_not_a_transfer(self):
        _, jnp, JA = _jax()
        assert JA.check_transfer(JA.capture(
            lambda x: x * 2 + 1, jnp.ones((4,)), compile=False)) == []
        assert A.check_transfer(A.capture(lambda x: x * 2 + 1,
                                          torch.ones(4))) == []
        # a scalar made on the device is no copy either
        assert A.check_transfer(A.capture(
            lambda x: x + torch.full((), 2.0, device=x.device),
            torch.ones(4), fake=True, fake_device="cuda")) == []

    def test_cross_device_copy_true_positive(self):
        t = A.capture(lambda x: x.cpu() * 2, torch.ones(4), fake=True,
                      fake_device="cuda")
        findings = A.check_transfer(t)
        assert findings and "_to_copy" in findings[0].op


# ---------------------------------------------------------------------------
# MASK
# ---------------------------------------------------------------------------

class TestMaskRule:
    MASK = torch.tensor([1.0, 0.0, 1.0, 1.0])

    def test_traced_consumption_true_negative(self):
        base = torch.arange(4.0)
        assert A.check_mask(lambda m: (m * base).sum(), self.MASK) == []

    def test_python_branch_true_positive(self):
        _, jnp, JA = _jax()

        def branchy(m):
            if m[0] > 0:                      # a host read of the mask
                return torch.zeros(())
            return torch.ones(())

        def jbranchy(m):
            if m[0] > 0:
                return jnp.zeros(())
            return jnp.ones(())
        ours = A.check_mask(branchy, self.MASK, name="branchy")
        theirs = JA.check_mask(jbranchy, jnp.asarray([1.0, 0.0, 1.0, 1.0]),
                               name="branchy")
        assert [f.op for f in ours] == [f.op for f in theirs] == \
            ["python-branch"]

    def test_ignored_mask_true_positive(self):
        findings = A.check_mask(lambda m: torch.arange(4.0).sum(),
                                self.MASK, name="ignoring")
        assert findings and findings[0].op == "<unused>"

    def test_taint_follows_in_place_writes(self):
        def scatter(m):
            out = torch.zeros(4)
            out[:2] = m[:2] * 3
            return out
        assert A.check_mask(scatter, self.MASK) == []


# ---------------------------------------------------------------------------
# COLLECTIVES
# ---------------------------------------------------------------------------

_AR_HLO = """
ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024] parameter(0)
  ROOT %ar = f32[1024] all-reduce(%p0), replica_groups=[1,8]<=[8], to_apply=%add
}
"""


def _all_reduce_trace():
    from repro_torch.dist.sharded import all_reduce_
    with fake_world(8):
        return A.capture(lambda t: all_reduce_(t, "x"), torch.zeros(1024))


class TestCollectivesRule:
    # a rank hands 4096 B to the all_reduce (JAX counts the ring's moved
    # bytes: 4096 * 2 * 7/8 = 7168 B)
    def test_over_budget_true_positive(self):
        _, _, JA = _jax()
        ours = A.check_collectives(_all_reduce_trace(),
                                   max_bytes_per_device=1000.0)
        theirs = JA.check_collectives(JA.Graph("ar", None, _AR_HLO), 8,
                                      max_bytes_per_device=1000.0)
        assert ours and "4.096e+03" in ours[0].message
        assert theirs and "7.168e+03" in theirs[0].message
        assert ours[0].rule == theirs[0].rule and ours[0].op == theirs[0].op

    def test_within_budget_true_negative(self):
        _, _, JA = _jax()
        assert A.check_collectives(_all_reduce_trace(),
                                   max_bytes_per_device=1e6) == []
        assert JA.check_collectives(JA.Graph("ar", None, _AR_HLO), 8,
                                    max_bytes_per_device=1e6) == []

    def test_requires_a_process_group(self):
        _, jnp, JA = _jax()
        with pytest.raises(ValueError):
            A.check_collectives(A.capture(lambda x: x, torch.ones(())),
                                max_bytes_per_device=1.0)
        with pytest.raises(ValueError):
            JA.check_collectives(JA.capture(lambda x: x, jnp.ones(()),
                                            compile=False), 8,
                                 max_bytes_per_device=1.0)


# ---------------------------------------------------------------------------
# RECOMPILE
# ---------------------------------------------------------------------------

class TestRecompileRule:
    def test_shape_polymorphic_drive_true_positive(self):
        jax, jnp, JA = _jax()
        ours = A.check_recompile(lambda x: x.sum(),
                                 [(torch.ones(n),) for n in (3, 4, 5)],
                                 name="shapeful")
        theirs = JA.check_recompile(jax.jit(lambda x: x.sum()),
                                    [(jnp.ones((n,)),) for n in (3, 4, 5)],
                                    name="shapeful")
        for f in (ours, theirs):
            assert f and "compiled 3x" in f[0].message

    def test_python_scalar_is_a_recompile(self):
        """A value reaching an op as a Python scalar: one program each."""
        f = A.check_recompile(lambda x, s: x * s,
                              [(torch.ones(4), s) for s in (1.0, 2.0)])
        assert f and "compiled 2x" in f[0].message

    def test_value_variants_true_negative(self):
        jax, jnp, JA = _jax()
        assert A.check_recompile(
            lambda x: x * 2, [(torch.full((4,), float(i)),)
                              for i in range(5)]) == []
        assert JA.check_recompile(
            jax.jit(lambda x: x * 2), [(jnp.full((4,), float(i)),)
                                       for i in range(5)]) == []

    def test_assert_raises_contract_violation(self):
        jax, jnp, JA = _jax()
        with pytest.raises(A.ContractViolation):
            A.assert_no_recompile(lambda x: x.sum(),
                                  [(torch.ones(n),) for n in (2, 3)])
        with pytest.raises(JA.ContractViolation):
            JA.assert_no_recompile(jax.jit(lambda x: x.sum()),
                                   [(jnp.ones((n,)),) for n in (2, 3)])

    def test_rejects_what_it_cannot_run(self):
        """JAX: ``cache_size`` of a plain function; the port: a harness
        handed something that is no entry point."""
        _, _, JA = _jax()
        with pytest.raises(TypeError):
            JA.cache_size(lambda x: x)
        with pytest.raises(TypeError):
            A.check_recompile(None, [(torch.ones(2),)])


# ---------------------------------------------------------------------------
# @contract
# ---------------------------------------------------------------------------

class TestContractDecorator:
    def _bad(self):
        calls = {"n": 0}

        @A.contract(fp32_contractions=True)
        def entry(c, a, b):
            calls["n"] += 1
            return torch.addmm(c, a, b)

        return entry, calls

    def _args(self):
        x, w = _bf16_mats()
        return torch.zeros(4, 4, dtype=BF), x, w

    def _jax_bad(self):
        _, jnp, JA = _jax()
        calls = {"n": 0}

        @JA.contract(fp32_contractions=True)
        def entry(a, b):
            calls["n"] += 1
            return a @ b
        rng = np.random.default_rng(0)
        args = (jnp.asarray(rng.normal(size=(4, 8)), jnp.bfloat16),
                jnp.asarray(rng.normal(size=(8, 4)), jnp.bfloat16))
        return entry, calls, args

    def test_zero_cost_when_disabled(self, monkeypatch):
        entry, calls = self._bad()
        jentry, jcalls, jargs = self._jax_bad()

        def never(*a, **k):
            raise AssertionError("a trace ran with contracts off")
        monkeypatch.setattr(contract_mod, "capture", never)
        entry(*self._args())                # no checking machinery ran
        jentry(*jargs)
        assert calls["n"] == jcalls["n"] == 1

    def test_violation_when_enabled(self):
        entry, _ = self._bad()
        with A.checking():
            with pytest.raises(A.ContractViolation) as ei:
                entry(*self._args())
        assert ei.value.findings[0].rule == "precision"
        assert isinstance(ei.value, AssertionError)

    def test_signature_cache_checks_once(self, monkeypatch):
        calls, captures = {"n": 0}, {"n": 0}
        real = contract_mod.capture

        def counting(*a, **k):
            captures["n"] += 1
            return real(*a, **k)
        monkeypatch.setattr(contract_mod, "capture", counting)

        @A.contract(fp32_contractions=True)
        def entry(a):
            calls["n"] += 1
            return (a @ a.T).sum()

        x = torch.ones(3, 3)
        with A.checking():
            entry(x)                     # checked: the call itself, once
            entry(x)                     # cached signature: bare
            assert (calls["n"], captures["n"]) == (2, 1)
            entry(torch.ones(4, 4))      # new signature: checked
            assert (calls["n"], captures["n"]) == (3, 2)

    def test_capture_bypass(self):
        """A contracted call inside a running capture runs bare (JAX: a
        tracer passes through to the enclosing jit)."""
        jax, _, JA = _jax()
        entry, calls = self._bad()
        jentry, jcalls, jargs = self._jax_bad()
        with A.checking():
            A.capture(lambda *a: entry(*a), *self._args())
        with JA.checking():
            jax.jit(lambda a, b: jentry(a, b))(*jargs)
        assert calls["n"] == jcalls["n"] == 1

    def test_callable_max_dim_waiver(self):
        @A.contract(max_dim=lambda a, *r, **kw: (
            None if kw.get("oracle") else a.shape[0]))
        def entry(a, *, oracle=False):
            big = torch.zeros(a.shape[0] * 3)
            return a.sum() + big.sum()

        x = torch.ones(4)
        with A.checking():
            entry(x, oracle=True)        # waived
            with pytest.raises(A.ContractViolation):
                entry(x)

    def test_enable_disable_scoping(self):
        _, _, JA = _jax()
        for mod in (A, JA):
            assert not mod.contracts_enabled()
            with mod.checking():
                assert mod.contracts_enabled()
            assert not mod.contracts_enabled()

    def test_metadata_and_wrapped(self):
        _, jnp, JA = _jax()
        entry, _ = self._bad()

        @JA.contract(fp32_contractions=True)
        def jentry(a, b):
            return a @ b
        for e in (entry, jentry):
            assert e.__contract__["fp32_contractions"] is True
            assert callable(e.__wrapped__)
        assert set(entry.__contract__) == set(jentry.__contract__)

    def test_port_declarations_are_jaxs(self):
        """aggregate_tree, compressed_aggregate and fa_weights_from_gram
        carry JAX's declarations (the sharded twin is aggregate_tree's
        ``sharded=`` path)."""
        from repro.core import gram as jgram
        from repro.dist import aggregation as jagg

        from repro_torch.core import gram
        from repro_torch.dist import aggregation
        for ours, theirs in (
                (aggregation.aggregate_tree, jagg.aggregate_tree),
                (aggregation.compressed_aggregate,
                 jagg.compressed_aggregate),
                (gram.fa_weights_from_gram, jgram.fa_weights_from_gram)):
            a, b = dict(ours.__contract__), dict(theirs.__contract__)
            assert callable(a.pop("max_dim")) == callable(b.pop("max_dim"))
            assert a == b


# ---------------------------------------------------------------------------
# the contracts on the port's entry points
# ---------------------------------------------------------------------------

def _agg_inputs(seed):
    from repro_torch.analysis.entrypoints import _mask, _tree
    X, layout = _tree(seed)
    return X, layout, _mask()


@pytest.mark.parametrize("rule", ["mean", "flag", "pca", "median",
                                  "trimmed_mean", "meamed", "phocas", "krum",
                                  "multi_krum", "bulyan", "geomed"])
def test_aggregate_tree_contract_holds_for_every_rule(rule):
    from repro_torch.analysis.entrypoints import _agg_cfg
    from repro_torch.dist.aggregation import aggregate_tree
    X, _, mask = _agg_inputs(3)
    cfg = _agg_cfg(rule)
    with A.checking():
        d, _ = aggregate_tree(X, cfg)
        dm, _ = aggregate_tree(X, cfg, mask=mask)
    bare, _ = aggregate_tree(X, cfg)
    bare_m, _ = aggregate_tree(X, cfg, mask=mask)
    assert torch.equal(d, bare) and torch.equal(dm, bare_m)


def test_compressed_aggregate_contract_holds_for_both_routes():
    from repro_torch.analysis.entrypoints import _agg_cfg
    from repro_torch.comm import CommConfig, init_ef
    from repro_torch.dist.aggregation import compressed_aggregate
    X, layout, mask = _agg_inputs(4)
    sketch = CommConfig(codec="countsketch", sketch_ratio=0.25)
    with A.checking():
        d, _, _ = compressed_aggregate(X.clone(), _agg_cfg("flag"), sketch,
                                       layout=layout, mask=mask)
    assert torch.isfinite(d).all()
    ef = init_ef(torch.zeros(layout.numel), X.shape[0])
    ef_bare = ef.clone()
    with A.checking():
        d1, _, new_ef = compressed_aggregate(
            X.clone(), _agg_cfg("mean"), CommConfig(codec="signsgd"), ef,
            layout=layout)
    d2, _, new_bare = compressed_aggregate(
        X.clone(), _agg_cfg("mean"), CommConfig(codec="signsgd"), ef_bare,
        layout=layout)
    # a checked call leaves the EF memory as one bare call leaves it
    assert torch.equal(d1, d2) and torch.equal(new_ef, new_bare)
    assert torch.equal(ef, ef_bare)


def test_checked_train_step_leaves_state_as_one_step():
    from repro_torch.analysis.entrypoints import _smoke_cfg, _train_config
    from repro_torch.comm import CommConfig
    from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                             init_train_state)
    from repro_torch.optim import adamw, constant
    import dataclasses
    cfg = _smoke_cfg("float32")
    tc = dataclasses.replace(_train_config(4),
                             comm=CommConfig(codec="signsgd"))
    assert isinstance(tc, TrainConfig)
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (4, 2, 8)).astype(np.int32))
             for k in ("tokens", "labels")}
    states = []
    for on in (True, False):
        torch.manual_seed(0)
        opt = adamw()
        state = init_train_state(cfg, opt, comm=tc.comm, workers=4)
        step = build_train_step(cfg, tc, opt, constant(1e-3))
        with A.checking(on):
            step(state, batch, 1)
        states.append(state)
    a, b = states
    assert torch.equal(a.flat, b.flat) and torch.equal(a.ef, b.ef)
    for k in a.opt_state:
        va, vb = a.opt_state[k], b.opt_state[k]
        assert (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                else va == vb)


def test_fa_weights_contract_bounds_dims_by_p():
    from repro_torch.core.flag import FlagConfig
    from repro_torch.core.gram import fa_weights_from_gram, gram_matrix
    rng = np.random.default_rng(23)
    K = gram_matrix(torch.from_numpy(rng.normal(size=(64, 16)).astype(
        np.float32)))
    with A.checking():
        c, _ = fa_weights_from_gram(K, FlagConfig(lam=16.0))
        cq, _ = fa_weights_from_gram(K, FlagConfig(lam=16.0),
                                     solver="qspace")   # bound waived
    assert c.shape == cq.shape == (16,)


# ---------------------------------------------------------------------------
# the models' bf16 paths (JAX's PRECISION lint-regression fixtures)
# ---------------------------------------------------------------------------

class TestModelPrecisionFixtures:
    def _clean(self, fn, *args):
        findings = A.check_precision(A.capture(fn, *args))
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_linear_bf16(self):
        from repro_torch.models import layers
        rng = np.random.default_rng(0)
        p = {"w": torch.from_numpy(rng.normal(size=(16, 8)).astype(
            np.float32))}
        self._clean(lambda x: layers.linear(p, x, BF),
                    torch.ones(2, 16, dtype=BF))

    def test_unembed_bf16(self):
        from repro_torch.models import layers
        self._clean(lambda x: layers.unembed({"table": torch.ones(32, 16)},
                                             x, BF),
                    torch.ones(2, 16, dtype=BF))

    def test_moe_bf16(self):
        from repro_torch.configs import get_config, reduce_for_smoke
        from repro_torch.models import moe
        cfg = reduce_for_smoke(get_config("deepseek-moe-16b")).replace(
            compute_dtype="bfloat16")
        m, d = cfg.moe, cfg.d_model
        de = m.d_expert or cfg.d_ff
        rng = np.random.default_rng(2)

        def bank(n, a, b):
            return torch.from_numpy((rng.normal(size=(n, a, b)) * 0.05)
                                    .astype(np.float32))
        p = {"router": {"w": bank(1, d, m.num_experts)[0]},
             "w_up": bank(m.num_experts, d, de),
             "w_gate": bank(m.num_experts, d, de),
             "w_down": bank(m.num_experts, de, d),
             "shared": {"w_up": bank(m.num_shared, d, de),
                        "w_gate": bank(m.num_shared, d, de),
                        "w_down": bank(m.num_shared, de, d)}}
        self._clean(lambda x: moe.moe_apply(p, x, cfg),
                    torch.ones(2, 8, d, dtype=BF))

    def test_blockdiag_bf16(self):
        from repro_torch.models import ssm
        rng = np.random.default_rng(1)
        p = {"w": torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(
            np.float32))}
        self._clean(lambda x: ssm._blockdiag_apply(p, x, BF),
                    torch.ones(2, 32, dtype=BF))

    def test_codec_paths_bf16(self):
        from repro_torch.analysis.entrypoints import _agg_cfg
        from repro_torch.comm import CommConfig, init_ef
        from repro_torch.dist.aggregation import compressed_aggregate
        from repro_torch.weights import layout_of
        rng = np.random.default_rng(3)
        X = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
        layout = layout_of({"a": torch.empty(64)})
        cs = CommConfig(codec="countsketch", sketch_ratio=0.25)
        self._clean(lambda x: compressed_aggregate(
            x, _agg_cfg("flag"), cs, layout=layout), X.to(BF).float())
        ef = init_ef(torch.zeros(64), 4)
        self._clean(lambda x: compressed_aggregate(
            x, _agg_cfg("flag"), CommConfig(codec="signsgd"), ef,
            layout=layout), X.to(BF).float())


# ---------------------------------------------------------------------------
# kernel rules: seeded mutants, each with its clean case
# ---------------------------------------------------------------------------

_CLEAN_CU = """
#include <cfloat>
__device__ float pad() { return FLT_MAX; }   // a finite sentinel
// INFINITY in a comment is no constant
"""


class TestKernelSentinel:
    @pytest.mark.parametrize("token", [
        "INFINITY", "CUDART_INF_F", "HUGE_VALF",
        "__int_as_float(0x7f800000)", "-__int_as_float(0xff800000)",
        "std::numeric_limits<float>::infinity()"])
    def test_nonfinite_pad_true_positive(self, token):
        src = _CLEAN_CU + f"__device__ float bad() {{ return {token}; }}\n"
        findings = K.check_kernel_sentinel({"mutant.cu": src})
        assert len(findings) == 1 and findings[0].rule == "ksentinel"
        assert findings[0].evidence.startswith("mutant.cu:")

    def test_finite_pad_true_negative(self):
        assert K.check_kernel_sentinel({"clean.cu": _CLEAN_CU}) == []

    def test_repository_sources(self):
        """The masked-selection sources hold +inf pads, each line found,
        and clean only through their allow-list entry (whose reason names
        test_sentinel_cases_match_jax)."""
        raw = K.check_kernel_sentinel(allowed={})
        files = {f.evidence.split(":")[0] for f in raw}
        assert files == set(K.SENTINEL_SOURCES)
        assert K.check_kernel_sentinel() == []
        assert all("test_sentinel_cases_match_jax" in r
                   for r in K.KSENTINEL_ALLOWED.values())


def test_sentinel_cases_match_jax():
    """KSENTINEL's resolution: the port's plain versions (the kernels are
    held bit-equal to them on the card) against the JAX package wherever
    a +inf pad can reach an output -- a column with every worker inactive
    (the masked median, trimmed mean, MeaMed, Phocas), Krum with fewer
    than k candidates (W = 1: exactly one missing), Bulyan's later rounds
    and masked Krum / Bulyan.  Every output equals JAX's default route
    (``impl="xla"``, and the masked references) bit for bit.  JAX's own
    Pallas kernels pad with ``finfo.max`` and differ from that route in
    exactly two degenerate cases, which the port follows the reference
    in: the all-inactive trimmed mean and W = 1 Krum give finfo.max there
    and +inf in the reference."""
    import jax.numpy as jnp

    from repro.core import aggregators as jagg
    from repro.kernels.coord_stats import ops as jops
    from repro.kernels.coord_stats.kernel import (bulyan_select_pallas,
                                                  coord_stats_pallas,
                                                  krum_scores_pallas)
    from repro_torch.core import aggregators as tagg
    from repro_torch.kernels.coord_stats.ref import (bulyan_select_plain,
                                                     coord_stat_plain,
                                                     krum_scores_plain)
    rng = np.random.default_rng(27)
    same = lambda a, b: np.array_equal(np.asarray(a), np.asarray(b),  # noqa
                                       equal_nan=True)
    kernel_only = []
    for W, f in ((5, 1), (15, 3)):
        X = rng.normal(size=(W, 64)).astype(np.float32)
        for mask in (np.zeros(W), np.r_[1.0, np.zeros(W - 1)],
                     np.r_[np.ones(2), np.zeros(W - 2)]):
            for op in ("median", "trimmed_mean", "meamed", "phocas"):
                ours = coord_stat_plain(torch.from_numpy(X), op, f,
                                        mask=torch.from_numpy(mask))
                ref = jagg.MASKED_COORDWISE[op](
                    jnp.asarray(X), jnp.asarray(mask, jnp.float32), f=f)
                assert same(ours.numpy(), ref), (W, mask, op, f)
                kern = coord_stats_pallas(
                    jnp.asarray(X), jnp.asarray(mask, jnp.float32),
                    op=op, f=f, interpret=True)
                if not same(ours.numpy(), kern):
                    kernel_only.append((op, int(mask.sum())))
    for p, f in ((1, 0), (1, 1), (2, 0), (2, 1), (3, 1), (5, 1), (9, 3)):
        D = rng.random((p, p)).astype(np.float32)
        D = D + D.T
        np.fill_diagonal(D, 0)
        ours = krum_scores_plain(torch.from_numpy(D), f).numpy()
        assert same(ours, jops.krum_scores(jnp.asarray(D), f=f))
        if not same(ours, krum_scores_pallas(jnp.asarray(D), f=f,
                                             interpret=True)):
            kernel_only.append(("krum", p))
        picks = bulyan_select_plain(torch.from_numpy(D), f).numpy()
        assert same(picks, jops.bulyan_select(jnp.asarray(D), f=f))
        assert same(picks, bulyan_select_pallas(jnp.asarray(D), f=f,
                                                interpret=True))
    for W, f in ((8, 1), (8, 2), (6, 2), (5, 1)):
        G = rng.normal(size=(W, 40)).astype(np.float32)
        D = ((G[:, None] - G[None]) ** 2).sum(-1).astype(np.float32)
        for mask in (np.r_[np.ones(W - 3), np.zeros(3)],
                     np.r_[0.0, np.ones(W - 1)], np.r_[np.zeros(W - 1), 1.0],
                     np.r_[np.ones(2), np.zeros(W - 2)]):
            m_t = torch.from_numpy(mask.astype(np.float32))
            m_j = jnp.asarray(mask, jnp.float32)
            ts, tt = tagg.masked_bulyan_select(torch.from_numpy(D), f, m_t)
            js, jt = jagg.masked_bulyan_select(jnp.asarray(D), f, m_j)
            assert same(ts.numpy(), js) and int(tt) == int(jt)
            assert same(tagg.masked_krum_scores(torch.from_numpy(D), f,
                                                m_t).numpy(),
                        jagg.masked_krum_scores(jnp.asarray(D), f, m_j))
    assert sorted(set(kernel_only)) == [("krum", 1), ("trimmed_mean", 0)]


_PTXAS_SPILL = """\
ptxas info    : Compiling entry function '_Z6mutantPf' for 'sm_90a'
ptxas info    : Function properties for _Z6mutantPf
    64 bytes stack frame, 28 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 772 bytes smem
ptxas info    : Compiling entry function '_Z5cleanPf' for 'sm_90a'
ptxas info    : Function properties for _Z5cleanPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 2560 bytes smem
"""

# PR 26's build on the H100 (sm_90a), as _build keeps them: the main
# path's instantiations and the spilling coord_stats widths
_PTXAS_H100 = [
    "_ZN39_GLOBAL__N__1da462e1_7_gram_cu_8a360b1912gram_offdiagIfLb0EEEvPKT_NS_4WalkEiiPf: 168 registers, used 1 barriers, 2560 bytes smem",
    "_ZN39_GLOBAL__N__1da462e1_7_gram_cu_8a360b199gram_diagIfLb0EEEvPKT_NS_4WalkEiPf: 164 registers, used 1 barriers, 2720 bytes smem",
    "_ZN39_GLOBAL__N__1da462e1_7_gram_cu_8a360b1911gram_reduceEPKfiifPf: 32 registers, used 0 barriers",
    "_ZN48_GLOBAL__N__2472401e_15_weighted_sum_cu_61d42c0517weighted_sum_vec4IfEEvPKT_xxiPKfPS1_: 32 registers, used 0 barriers",
    "_ZN47_GLOBAL__N__1122da9b_14_coord_stats_cu_ccb9abcb18coord_stats_kernelILi16EfEEvPKT0_xPKiixiiPKfPf: 96 registers, used 1 barriers, 196 bytes smem",
    "_ZN47_GLOBAL__N__1122da9b_14_coord_stats_cu_ccb9abcb18coord_stats_kernelILi64EfEEvPKT0_xPKiixiiPKfPf: 16 bytes stack frame, 28 bytes spill stores, 24 bytes spill loads",
    "_ZN47_GLOBAL__N__1122da9b_14_coord_stats_cu_ccb9abcb18coord_stats_kernelILi64EfEEvPKT0_xPKiixiiPKfPf: 255 registers, used 1 barriers, 16 bytes cumulative stack size, 772 bytes smem",
    "_ZN47_GLOBAL__N__1122da9b_14_coord_stats_cu_ccb9abcb18coord_stats_kernelILi128EfEEvPKT0_xPKiixiiPKfPf: 880 bytes stack frame, 1532 bytes spill stores, 1032 bytes spill loads",
    "_ZN47_GLOBAL__N__1122da9b_14_coord_stats_cu_ccb9abcb18coord_stats_kernelILi128EfEEvPKT0_xPKiixiiPKfPf: 255 registers, used 1 barriers, 880 bytes cumulative stack size, 1540 bytes smem",
    "_ZN47_GLOBAL__N__c4c4e4d9_14_krum_select_cu_e7bea83516krum_scores_warpILi16EEEvPKfiiPf: 26 registers, used 0 barriers",
    "_ZN47_GLOBAL__N__c4c4e4d9_14_krum_select_cu_e7bea83518bulyan_select_warpILi16EEEvPKfiiiPi: 62 registers, used 0 barriers",
    "_ZN46_GLOBAL__N__af087e53_13_flash_attn_cu_efb7a86d12flash_fwd_tcILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16NS_7StridesEiiifiii: 117 registers, used 1 barriers",
    "_ZN46_GLOBAL__N__72ef4e4e_13_flash_attn_cu_efb7a86d9flash_fwdILi256EEEv14CUtensorMap_stS1_S1_PfNS_7StridesEiiiifiii: 230 registers, used 1 barriers",
]


class TestKernelBudget:
    def test_spill_true_positive_and_clean_case(self):
        budgets = K.parse_ptxas(_PTXAS_SPILL)
        assert budgets["_Z6mutantPf"].spill_stores == 28
        assert budgets["_Z5cleanPf"] == K.KernelBudget(
            "_Z5cleanPf", registers=32, smem=2560)
        findings = K.check_kernel_budget(budgets)
        assert [(f.rule, f.op) for f in findings] == [("kbudget", "spill")]
        assert "_Z6mutantPf" in findings[0].message

    def test_shared_memory_over_the_limit(self):
        line = "_Z3bigPf: 64 registers, used 1 barriers, 240000 bytes smem"
        findings = K.check_kernel_budget(K.parse_ptxas([line]))
        assert [f.op for f in findings] == ["smem"]
        assert K.check_kernel_budget(K.parse_ptxas([line]),
                                     max_smem=250_000) == []

    def test_recorded_h100_build(self):
        """The main path's instantiations spill nothing and fit the
        shared memory; only coord_stats at R = 64 / 128 spills, allowed
        as off the main path."""
        budgets = K.parse_ptxas(_PTXAS_H100)
        assert K.check_kernel_budget(budgets) == []
        flagged = K.check_kernel_budget(budgets, allowed={})
        assert sorted(re.search(r"ILi(\d+)E", f.message).group(1)
                      for f in flagged) == ["128", "64"]

    def test_dynamic_smem_mirrors_the_source(self):
        """dynamic_smem's formulas are flash_attn.cu's constants, and every
        head dim of both bodies fits the shared memory a block may have."""
        src = (CSRC / "flash_attn.cu").read_text()
        for pat in (r"constexpr int kBQ = 64;", r"constexpr int kStages = 2;",
                    r"kBK = D <= 128 \? 64 : 32;",
                    r"kBarOff = kQBytes \+ 2 \* kStages \* kKVBytes;",
                    r"kSmem = kBarOff \+ 8 \* \(1 \+ kStages\) \+ 1024;",
                    # the fp32 body's F32Tile
                    r"constexpr int kSlots = 3;",
                    r"kTM = D <= 128 \? 8 : 4;", r"kBK = D <= 64 \? 64 : 32;",
                    r"kWarps = D == 64 \? 8 : 4;", r"kRW = kTM \* kTY;",
                    r"kBQ = kRW \* kWarps;", r"kW = D < 128 \? D : 128;",
                    r"kLD = kW \+ 4;", r"kLQ = kBQ \+ 4;", r"kLP = kRW \+ 4;",
                    r"kQFloats = D \* kLQ;",
                    r"kKVFloats = kBK \* kBoxes \* kLD;",
                    r"kPFloats = kWarps \* kBK \* kLP;",
                    r"4 \* \(kQFloats \+ kSlots \* kKVFloats \+ kPFloats\);",
                    r"kSmem = kBarOff \+ 8 \* \(1 \+ kSlots\) \+ 4 \* kSlots "
                    r"\+ 128;"):
            assert re.search(pat, src), pat
        tc = "flash_fwd_tcILi64EEEv14CUtensorMap"
        assert K.dynamic_smem(tc) == 64 * 64 * 2 + 4 * 64 * 64 * 2 + 24 \
            + 1024
        # d = 64: 8 warps of 32 rows, 3 slots of 64 keys, rows of 68 floats
        assert K.dynamic_smem("flash_fwdILi64EEEv14CUtensorMap") == 4 * (
            64 * 260 + 3 * 64 * 68 + 8 * 64 * 36) + 32 + 12 + 128
        # d = 96: 4 warps of 32 rows, 32-key tiles: two blocks an SM
        assert K.dynamic_smem("flash_fwdILi96EEEv14CUtensorMap") == 4 * (
            96 * 132 + 3 * 32 * 100 + 4 * 32 * 36) + 32 + 12 + 128
        assert 2 * K.dynamic_smem("flash_fwdILi96E") <= 228 * 1024 - 2048
        # d = 256: 4 warps of 16 rows, 32-key tiles in two boxes of 132
        assert K.dynamic_smem("flash_fwdILi256EEEv14CUtensorMap") == 4 * (
            256 * 68 + 3 * 32 * 264 + 4 * 32 * 20) + 32 + 12 + 128
        assert K.dynamic_smem("flash_fwdIfLi256EEEv") == 0   # no such body
        assert K.dynamic_smem("gram_reduceEPKfiifPf") == 0
        for d in (64, 96, 128, 256):
            assert K.dynamic_smem(f"flash_fwd_tcILi{d}E") <= \
                K.SMEM_LIMIT_BYTES
            assert 0 < K.dynamic_smem(f"flash_fwdILi{d}E") <= \
                K.SMEM_LIMIT_BYTES


class TestKernelSites:
    def test_site_count(self):
        from repro_torch.kernels.gram.kernel import gram_cuda
        t = A.capture(gram_cuda, torch.empty(256, 8), fake=True,
                      fake_device="cuda")
        assert [op.packet for op in t.sites()] == ["gram"]
        assert A.check_kernel_sites(t, expect_sites=1) == []
        findings = A.check_kernel_sites(t, expect_sites=2)
        assert findings and findings[0].rule == "ksites"

    def test_cpu_route_launches_nothing(self):
        from repro_torch.kernels.gram.ops import gram
        t = A.capture(gram, torch.ones(256, 8))
        assert t.sites() == []


class TestSanitizer:
    def test_clean_run(self):
        out = "========= COMPUTE-SANITIZER\n========= ERROR SUMMARY: 0 errors\n"
        assert K.check_sanitizer("racecheck", out, 0) == []

    def test_errors_and_failures(self):
        bad = "========= Race reported\n========= ERROR SUMMARY: 3 errors\n"
        assert [f.op for f in K.check_sanitizer("racecheck", bad, 0)] == \
            ["racecheck"]
        assert K.check_sanitizer("memcheck", "no summary", 0)
        assert K.check_sanitizer(
            "initcheck", "========= ERROR SUMMARY: 0 errors", 1)


# ---------------------------------------------------------------------------
# findings, reports, the allowed scope
# ---------------------------------------------------------------------------

def _findings(module):
    return [module.Finding("precision", "dot", "entry", "x = dot(a, b) " * 9,
                           "low precision"),
            module.Finding("shape", "<absent>", "g", "dims seen: [4]",
                           "none of the required dimensions")]


def test_format_findings_and_report_json_equal_jaxs():
    from repro.analysis import findings as jf

    from repro_torch.analysis import findings as tf
    for fs in ([], _findings(tf)):
        jfs = [jf.Finding(**f.to_dict()) for f in fs]
        assert tf.format_findings(fs) == jf.format_findings(jfs)
        assert tf.format_findings(fs, header="h\n") == \
            jf.format_findings(jfs, header="h\n")
        ours, theirs = tf.Report(), jf.Report()
        ours.add("a/b", fs)
        ours.add("c", [])
        theirs.add("a/b", jfs)
        theirs.add("c", [])
        assert json.dumps(ours.to_dict()) == json.dumps(theirs.to_dict())
        assert ours.render() == theirs.render()
        assert str(tf.ContractViolation(fs, name="n")) == \
            str(jf.ContractViolation(jfs, name="n"))


def test_allowed_is_inert_outside_a_capture():
    before = dict(_Checks.hits)
    with A.allowed("transfer", "test: inert"):
        torch.ones(2).sum().item()
    assert _Checks.hits == before and _Checks.scopes == []


def test_evidence_names_the_issuing_port_frame():
    from repro_torch.kernels.gram.ops import gram
    t = A.capture(gram, torch.ones(16, 4))
    assert any(op.site.startswith("repro_torch/kernels/gram/")
               for op in t.ops)


def test_rule_registry_lists_every_family():
    assert {"shape", "precision", "transfer", "mask", "collectives",
            "recompile", "ksites", "kbudget", "ksentinel",
            "ksanitizer"} == set(A.RULES)
