"""The port's fleetlint (`repro_torch.testing.fleetlint`):
tests/test_fleetlint.py's paired firing / passing fixtures per rule
under the port's paths, pragma behaviour, the port's host-sync syncs
(`.item()`, `.cpu()`, `.tolist()`, `.numpy()`, casts of torch-valued
expressions), `src/` clean under the port's rules (the JAX tree and the
port's alike), and the runtime sanitizer on the port's JobBank /
SharedEngine (borrow fingerprinting + transfer guard), on the CPU."""
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.testing.fleetlint import (check_module,  # noqa: E402
                                           default_rules,
                                           module_from_source)
from repro_torch.testing.fleetlint.rules import (  # noqa: E402
    REFERENCE_ONLY, BorrowedStackRule, DeterminismRule, HostSyncRule,
    PerMemberLoopRule, PragmaReasonRule, ProfileResolutionRule,
    RowsDisciplineRule, SyncBeforeCaptureRule)
from repro_torch.testing.fleetlint.runtime import (  # noqa: E402
    FleetlintRuntimeError, install, installed, uninstall)

CORE = "src/repro_torch/core/mod.py"


def lint(src, rule, rel=CORE):
    mod = module_from_source(textwrap.dedent(src), rel)
    return check_module(mod, [rule])


def names(findings):
    return [f.rule for f in findings]


# -- rule fixtures: one firing + one passing snippet each -------------------

def test_borrowed_stack_fires_on_attribute_store():
    bad = """
    class C:
        def cache(self):
            self.stack = self.bank.params_stack()
    """
    assert names(lint(bad, BorrowedStackRule())) == ["borrowed-stack"]


def test_borrowed_stack_fires_on_escape_via_return():
    bad = """
    def leak(bank):
        s = bank.params_stack_compute("bf16")
        return s
    """
    assert names(lint(bad, BorrowedStackRule())) == ["borrowed-stack"]


def test_borrowed_stack_passes_local_use_and_snapshots():
    good = """
    class C:
        def use(self):
            s = self.bank.params_stack()
            score(s)
        def keep(self):
            self.snap = self.bank.snapshot_params(0)   # committed copy
    """
    assert lint(good, BorrowedStackRule()) == []


def test_sync_before_capture_fires_without_compact():
    bad = """
    def dispatch(jobs, bank):
        idxs = [j._slot.idx for j in jobs]
        return bank.gather(idxs)
    """
    assert names(lint(bad, SyncBeforeCaptureRule())) \
        == ["sync-before-capture"]


def test_sync_before_capture_conditional_compact_still_fires():
    bad = """
    def dispatch(jobs, bank, maybe):
        if maybe:
            bank.compact()
        return [j._slot.idx for j in jobs]
    """
    assert names(lint(bad, SyncBeforeCaptureRule())) \
        == ["sync-before-capture"]


def test_sync_before_capture_passes_with_compact_first():
    good = """
    def dispatch(jobs, bank):
        bank.compact()
        return bank.gather([j._slot.idx for j in jobs])

    class Handle:
        def own(self):
            return self._slot.idx        # a handle's OWN index: exempt
    """
    assert lint(good, SyncBeforeCaptureRule()) == []


def test_per_member_loop_fires_in_core():
    bad = """
    def score(job, evs):
        return [m.eval_on(evs) for m in job.members]
    """
    assert names(lint(bad, PerMemberLoopRule())) == ["per-member-loop"]


def test_per_member_loop_passes_batched_and_out_of_scope():
    good = """
    def score(eng, jobs, evs):
        return eng.eval_pairs([(j, evs) for j in jobs])
    """
    assert lint(good, PerMemberLoopRule()) == []
    bad = "accs = [m.eval_on(e) for m in job.members]\n"
    # the rule scopes to plane code; test helpers are out of scope
    assert lint(bad, PerMemberLoopRule(), rel="tests/helper.py") == []
    assert names(lint(bad, PerMemberLoopRule(),
                      rel="src/repro_torch/examples/b.py")) \
        == ["per-member-loop"]
    # the JAX package's plane code is the JAX linter's
    assert lint(bad, PerMemberLoopRule(), rel="src/repro/core/m.py") == []


def test_rows_discipline_fires_on_handrolled_growth():
    bad = """
    import numpy as np
    class T:
        def grow(self, pad):
            self._acc = np.concatenate([self._acc, np.zeros(pad)])
    """
    assert names(lint(bad, RowsDisciplineRule())) == ["rows-discipline"]


def test_rows_discipline_passes_registry_sized_growth():
    good = """
    import numpy as np
    class T:
        def grow(self):
            pad = self._rows.capacity - self._acc.shape[0]
            self._acc = np.concatenate([self._acc, np.zeros(pad)])
    """
    assert lint(good, RowsDisciplineRule()) == []
    # core/rows.py itself is the sanctioned implementation
    bad = """
    import numpy as np
    class RowRegistry:
        def grow(self, pad):
            self._ids = np.concatenate([self._ids, np.zeros(pad)])
    """
    assert lint(bad, RowsDisciplineRule(),
                rel="src/repro_torch/core/rows.py") == []
    assert lint(bad, RowsDisciplineRule(),
                rel="src/repro/core/rows.py") == []
    grow = """
    import torch
    class T:
        def grow(self, pad):
            self._acc = torch.cat([self._acc, torch.zeros(pad)])
    """
    assert names(lint(grow, RowsDisciplineRule())) == ["rows-discipline"]


def test_host_sync_fires_on_item_and_torch_casts():
    bad = """
    import torch
    def decide(x):
        a = x.item()
        b = float(torch.mean(x))
        c = x.cpu()
        d = x.tolist()
        e = x.numpy()
        return a + b
    """
    got = names(lint(bad, HostSyncRule(),
                     rel="src/repro_torch/core/trainer.py"))
    assert got == ["host-sync"] * 5


def test_host_sync_passes_host_values_and_other_modules():
    good = """
    import numpy as np
    def decide(xs):
        return float(np.mean(xs))      # host numpy, no device sync
    """
    assert lint(good, HostSyncRule(),
                rel="src/repro_torch/core/trainer.py") == []
    bad = "import torch\nb = float(torch.mean(x))\n"
    # serve/ is not on the decision-plane allowlist
    assert lint(bad, HostSyncRule(),
                rel="src/repro_torch/serve/plane.py") == []
    # nor is the JAX package's trainer
    assert lint(bad, HostSyncRule(), rel="src/repro/core/trainer.py") == []


def test_determinism_fires_on_wallclock_unseeded_and_set_iter():
    bad = """
    import time
    import numpy as np
    def decide(flows):
        t = time.time()
        r = np.random.uniform(0, 1)
        for f in set(flows):
            pass
        return t + r
    """
    got = names(lint(bad, DeterminismRule()))
    assert got == ["determinism"] * 3


def test_determinism_passes_seeded_and_sorted():
    good = """
    import time
    import numpy as np
    def decide(flows, clock=time.monotonic):
        rng = np.random.default_rng(0)
        r = rng.uniform(0, 1)
        for f in sorted(set(flows)):
            pass
        return clock() + r
    """
    assert lint(good, DeterminismRule()) == []


def test_profile_resolution_fires_on_mixed_literal():
    bad = 'spec = {"configs": [[30, 32], [15, 16]], "acc": []}\n'
    assert names(lint(bad, ProfileResolutionRule(), rel="data/s.py")) \
        == ["profile-resolution"]


def test_profile_resolution_passes_uniform_literal():
    good = 'spec = {"configs": [[r, 32] for r in (30, 15, 5)], "acc": []}\n'
    assert lint(good, ProfileResolutionRule(), rel="data/s.py") == []


def test_mesh_compat_is_not_carried_but_its_pragmas_stay_known():
    """The port uses no version-moved JAX API, so the reference's
    mesh-compat rule has no port counterpart; a pragma naming it is no
    unknown rule to the port's pragma-reason rule."""
    assert "mesh-compat" not in {r.name for r in default_rules()}
    assert REFERENCE_ONLY == {"mesh-compat"}
    src = "x = 1  # fleetlint: disable=mesh-compat -- the JAX tree's shim\n"
    rule = PragmaReasonRule([r.name for r in default_rules()])
    assert lint(src, rule) == []


# -- pragma behavior ---------------------------------------------------------

def test_pragma_suppresses_same_line_and_next_code_line():
    src = """
    class C:
        def a(self):
            self.s = self.bank.params_stack()  # fleetlint: disable=borrowed-stack -- test
        def b(self):
            # fleetlint: disable=borrowed-stack -- justification may
            # continue over several comment lines before the code
            self.s = self.bank.params_stack()
    """
    assert lint(src, BorrowedStackRule()) == []


def test_pragma_only_covers_its_line():
    src = """
    class C:
        def a(self):
            self.s = self.bank.params_stack()  # fleetlint: disable=borrowed-stack -- test
            self.t = self.bank.params_stack()
    """
    assert names(lint(src, BorrowedStackRule())) == ["borrowed-stack"]


def test_pragma_disable_file():
    src = """
    # fleetlint: disable-file=borrowed-stack -- fixture file
    class C:
        def a(self):
            self.s = self.bank.params_stack()
        def b(self):
            self.t = self.bank.params_stack()
    """
    assert lint(src, BorrowedStackRule()) == []


def test_pragma_without_reason_or_unknown_rule_is_a_finding():
    src = """
    x = 1  # fleetlint: disable=borrowed-stack
    y = 2  # fleetlint: disable=no-such-rule -- because
    """
    rule = PragmaReasonRule([r.name for r in default_rules()])
    got = names(lint(src, rule))
    assert got == ["pragma-reason", "pragma-reason"]


def test_default_rule_set_has_the_seven_contract_rules():
    rules = default_rules()
    contract = [r for r in rules if r.name != "pragma-reason"]
    assert len(contract) == 7
    assert all(r.contract for r in rules)


# -- meta-test: the real tree is clean ---------------------------------------

@pytest.mark.parametrize("tree", ["src/repro_torch", "src", "benchmarks",
                                  "examples"])
def test_src_is_clean_under_the_port_rules(tree):
    from repro_torch.testing.fleetlint import run
    root = os.path.join(os.path.dirname(__file__), "..")
    findings = run([os.path.join(root, tree)], default_rules())
    assert findings == [], "\n".join(f.human() for f in findings)


def test_the_port_is_clean_under_the_reference_rules():
    from repro.testing.fleetlint import default_rules as jrules
    from repro.testing.fleetlint import run
    root = os.path.join(os.path.dirname(__file__), "..")
    findings = run([os.path.join(root, "src", "repro_torch")], jrules())
    assert findings == [], "\n".join(f.human() for f in findings)


# -- runtime sanitizer -------------------------------------------------------

@pytest.fixture()
def sanitizer():
    install()
    yield
    uninstall()


def _tiny_engine(resident=True):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core.trainer import SharedEngine
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=32,
                              d_model=16, d_ff=32, num_heads=2,
                              num_kv_heads=2, num_layers=1)
    return SharedEngine(cfg, resident=resident, device="cpu")


def _jobs(engine, n=2, seq=8):
    from repro_torch.core.grouping import Request
    from repro_torch.core.trainer import RetrainJob
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(n):
        data = rng.integers(0, 32, size=(4, seq)).astype(np.int32)
        req = Request(stream_id=f"s{i}", t=0.0, loc=(0.0, 0.0),
                      subsamples=data, acc=0.0, train_data=data)
        jobs.append(RetrainJob(engine, req, micro_steps=1, batch=2,
                               seed=i))
    return jobs


def test_sanitizer_catches_seeded_borrow_mutation(sanitizer):
    from repro_torch.models.param import tree_leaves
    eng = _tiny_engine(resident=False)   # host mode: leaves are numpy
    jobs = _jobs(eng)
    stack = eng.bank.params_stack()
    leaf = tree_leaves(stack)[0]
    leaf[...] += 1.0      # mutate the borrowed buffer IN PLACE,
    #                       bypassing the dirty-bit write protocol
    with pytest.raises(FleetlintRuntimeError, match="mutated in place"):
        eng.bank.compact()
    del jobs


def test_sanitizer_allows_legit_borrow_lifecycle(sanitizer):
    eng = _tiny_engine(resident=False)
    jobs = _jobs(eng)
    stack = eng.bank.params_stack()
    # a legitimate write retires the borrow (version bump) — no error
    jobs[0].state = jobs[0].state
    eng.bank.compact()
    del stack, jobs


def test_sanitizer_transfer_guard_catches_host_stack(sanitizer):
    eng = _tiny_engine(resident=True)
    jobs = _jobs(eng)
    eng.bank.compact()
    eng.bank.sync_to_device()
    host_stack = jobs[0].state["params"]           # numpy host copy
    from repro_torch.models.param import tree_map
    stacked = tree_map(
        lambda x: np.broadcast_to(x, (eng.bank.capacity,) + x.shape),
        host_stack)
    toks = np.stack([jobs[0].members[0].subsamples])
    with pytest.raises(FleetlintRuntimeError, match="h2d transfer"):
        # a host params stack fed to a batched decision call on a
        # RESIDENT bank: the per-job h2d the residency contract bans
        eng.batched_accuracy(stacked, toks, [0])
    del jobs


def test_sanitizer_silent_on_clean_batched_paths(sanitizer):
    eng = _tiny_engine(resident=True)
    jobs = _jobs(eng, n=3)
    eng.train_micro_many(jobs)
    pairs = [(j, j.members[0].subsamples) for j in jobs]
    a = eng.eval_pairs(pairs)
    assert len(a) == 3
    # and stats stay quiet across a warm repeat (no per-call crossings)
    stats = eng.bank.stats
    before = (stats.h2d_syncs, stats.d2h_syncs)
    b = eng.eval_pairs(pairs)
    assert a == b
    assert (stats.h2d_syncs, stats.d2h_syncs) == before
    del jobs


def test_sanitizer_install_uninstall_roundtrip():
    from repro_torch.core.trainer import JobBank, SharedEngine
    orig = (JobBank.params_stack, SharedEngine.eval_pairs)
    install()
    assert installed()
    install()                      # idempotent
    uninstall()
    assert not installed()
    assert (JobBank.params_stack, SharedEngine.eval_pairs) == orig


def test_sanitizer_parity_with_unpatched_engine():
    """The hooks change failure modes only, never values."""
    eng = _tiny_engine(resident=True)
    jobs = _jobs(eng, n=2)
    pairs = [(j, j.members[0].subsamples) for j in jobs]
    plain = eng.eval_pairs(pairs)
    install()
    try:
        guarded = eng.eval_pairs(pairs)
    finally:
        uninstall()
    assert plain == guarded
    del jobs


# -- satellite parity: the bench_heterogeneity grading fix -------------------

def test_eval_jobs_precision_override_matches_scalar_loop():
    """The batched fp32 grading pass (bench_heterogeneity) is
    bit-identical to the old per-member eval_on loop, including on a
    bf16-screened fleet."""
    eng = _tiny_engine(resident=True)
    jobs = _jobs(eng, n=2)
    for j in jobs:
        j.precision = "bf16"       # screens bf16; grading forces fp32
    batched = eng.eval_jobs(jobs, precision="fp32")
    # fleetlint: disable=per-member-loop -- the parity REFERENCE loop
    scalar = [float(np.mean([j.eval_on(m.subsamples, precision="fp32")
                             for m in j.members])) for j in jobs]
    assert batched == scalar
    del jobs
