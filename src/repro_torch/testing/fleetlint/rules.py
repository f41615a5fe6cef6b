"""The port's fleetlint rule set: one rule per plane contract, the JAX
package's rules (`repro/testing/fleetlint/rules.py`) on the port's tree.

Each rule encodes a convention the plane docs state in prose (the
`contract` attribute names the doc).  Rules are deliberately
approximate in the direction of FEW false positives: a miss costs a
review comment, a false positive costs a pragma — so every heuristic
here errs toward silence and the runtime sanitizer
(repro_torch.testing.fleetlint.runtime) backstops the static gaps.

Path scoping uses substring/endswith matches on the scanned path so the
rules work both on the real tree (``src/repro_torch/core/trainer.py``)
and on the fixture snippets the tests feed in under synthetic paths. The
scoped rules read the port's paths: plane code is ``repro_torch/core/``
and ``repro_torch/examples/`` (per-member-loop), ``repro_torch/core/``
and ``repro_torch/serve/`` (determinism), and the decision-plane modules
of ``repro_torch/core/`` (host-sync, whose syncs are torch's: ``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()`` and ``float()`` / ``int()`` /
``bool()`` of a torch-valued expression). Both packages' ``core/rows.py``
are the sanctioned RowRegistry, so either linter reads the other's tree
clean.

Not carried: the reference's mesh-compat rule. It guards the spellings of
JAX APIs that moved between releases (``shard_map``, the Pallas
``CompilerParams``), which only ``kernels/_compat.py`` may touch; the
port uses no such API and has no ``_compat.py``. The pragma-reason rule
still knows its name, so a pragma of the JAX tree that names it is no
unknown rule here.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.testing.fleetlint.engine import Finding, Module, Rule

# -- small AST helpers -------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions(node: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


def _functions(tree: ast.Module) -> Iterator[Tuple[ast.AST, Optional[str]]]:
    """(function node, enclosing class name) for every def in the file."""
    def visit(node: ast.AST, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from visit(child, cls)
            else:
                yield from visit(child, cls)
    yield from visit(tree, None)


_LOOPS = (ast.For, ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)


# -- rule 1: borrowed-stack --------------------------------------------------

class BorrowedStackRule(Rule):
    """`params_stack()` / `params_stack_compute()` results are BORROWED:
    valid only until the next bank write/scatter/compaction (the
    resident buffers are donated to the update kernels), so they may
    not be stored on an attribute or escape the function that captured
    them.  `snapshot_params` / `gather` / `row_device` return committed
    copies and are the escape hatch."""

    name = "borrowed-stack"
    contract = "docs/training_plane.md: params_stack() is borrowed; " \
               "capture right before the fleet call, never cache"

    _BORROW = {"params_stack", "params_stack_compute"}

    def _is_borrow_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self._BORROW)

    def check(self, module: Module) -> Iterator[Finding]:
        for fn, _cls in _functions(module.tree):
            if fn.name.startswith("params_stack"):
                continue        # the borrow SOURCE returns by design
            borrowed: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and self._is_borrow_call(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            borrowed.add(tgt.id)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    escapes = (self._is_borrow_call(node.value)
                               or (isinstance(node.value, ast.Name)
                                   and node.value.id in borrowed))
                    if escapes and any(isinstance(t, ast.Attribute)
                                       for t in node.targets):
                        yield self.finding(
                            module, node,
                            "borrowed params_stack() result stored on an "
                            "attribute; it dies at the next bank "
                            "write/compaction — use snapshot_params/"
                            "gather for a committed copy")
                elif isinstance(node, (ast.Return, ast.Yield)):
                    val = node.value
                    if val is not None and (
                            self._is_borrow_call(val)
                            or (isinstance(val, ast.Name)
                                and val.id in borrowed)):
                        yield self.finding(
                            module, node,
                            "borrowed params_stack() result escapes the "
                            "capturing function — the caller cannot see "
                            "the bank mutations that invalidate it")


# -- rule 2: sync-before-capture ---------------------------------------------

class SyncBeforeCaptureRule(Rule):
    """A function that captures ANOTHER job's bank slot index
    (`job._slot.idx`) must run the compaction entry point first,
    unconditionally (top-of-body, not behind a branch): queued-dead
    slots compact at entry points, so an index captured before
    `compact()` can silently point at a moved row.  Reading a handle's
    OWN index (`self._slot.idx`) is exempt — it is re-read fresh on
    every call."""

    name = "sync-before-capture"
    contract = "docs/training_plane.md: batched entry points compact + " \
               "flush BEFORE capturing slot indices"

    _IMPL_CLASSES = {"JobBank", "_Slot"}

    def _captures(self, node: ast.AST) -> Iterator[ast.Attribute]:
        for n in ast.walk(node):
            if (isinstance(n, ast.Attribute) and n.attr == "idx"
                    and isinstance(n.value, ast.Attribute)
                    and n.value.attr == "_slot"
                    and not (isinstance(n.value.value, ast.Name)
                             and n.value.value.id == "self")):
                yield n

    @staticmethod
    def _has_compact(node: ast.AST) -> bool:
        return any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "compact"
                   for n in ast.walk(node))

    def check(self, module: Module) -> Iterator[Finding]:
        for fn, cls in _functions(module.tree):
            if cls in self._IMPL_CLASSES:
                continue
            synced = False
            for stmt in fn.body:
                # an unconditional compact() call dominates everything
                # after it; one inside if/for/try does NOT count — the
                # contract is "on every path"
                if self._has_compact(stmt) and not any(
                        isinstance(n, (ast.If, ast.For, ast.While, ast.Try))
                        for n in ast.walk(stmt)):
                    synced = True
                    continue
                if synced:
                    continue
                for cap in self._captures(stmt):
                    yield self.finding(
                        module, cap,
                        "slot index captured before an unconditional "
                        "bank.compact() in this function — a queued-dead "
                        "slot may move this row after capture")


# -- rule 3: per-member-loop -------------------------------------------------

class PerMemberLoopRule(Rule):
    """Per-member/per-flow Python loops around the scalar decision
    calls (`decide` / `eval_on` / `best`) in plane code must go through
    the batched APIs (`decide_many` / `eval_pairs` / `eval_jobs` /
    `best_many`) — the batched paths are bit-identical and turn O(fleet)
    device launches into O(1)."""

    name = "per-member-loop"
    contract = "docs/transmission_plane.md + docs/training_plane.md: " \
               "no per-member scalar loops in plane code"

    _SCALAR = {"decide", "eval_on", "best"}
    _SCOPE = ("repro_torch/core/", "repro_torch/examples/")

    def check(self, module: Module) -> Iterator[Finding]:
        if not any(s in module.rel for s in self._SCOPE):
            return
        flagged: Dict[int, ast.AST] = {}
        stack: List[ast.AST] = []

        def visit(node: ast.AST):
            is_loop = isinstance(node, _LOOPS)
            if is_loop:
                stack.append(node)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._SCALAR and stack):
                loop = stack[-1]          # innermost enclosing loop
                flagged.setdefault(id(loop), loop)
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_loop:
                stack.pop()

        visit(module.tree)
        for loop in sorted(flagged.values(), key=lambda n: n.lineno):
            yield self.finding(
                module, loop,
                "per-member loop around a scalar decision call "
                "(decide/eval_on/best) — use the batched plane API "
                "(decide_many / eval_pairs / eval_jobs / best_many)")


# -- rule 4: rows-discipline -------------------------------------------------

class RowsDisciplineRule(Rule):
    """Growable per-row state must ride a RowRegistry (core/rows.py):
    hand-rolled `self.x = np.concatenate([self.x, ...])` growth forgets
    amortized doubling, swap-compaction, and mesh alignment.  Growth
    sized against a registry (`.capacity` / `.reserve()`) in the same
    function is exempt — that IS the discipline."""

    name = "rows-discipline"
    contract = "ROADMAP conventions: RowRegistry owns churn; owners " \
               "size arrays against .capacity"

    _CONCAT = {"np.concatenate", "numpy.concatenate", "torch.cat",
               "torch.concatenate"}

    def _is_self_concat(self, node: ast.Assign) -> bool:
        tgt = node.targets[0] if len(node.targets) == 1 else None
        if not isinstance(tgt, ast.Attribute):
            return False
        call = node.value
        if not (isinstance(call, ast.Call)
                and _dotted(call.func) in self._CONCAT and call.args):
            return False
        first = call.args[0]
        parts = first.elts if isinstance(first, (ast.List, ast.Tuple)) \
            else [first]
        return any(isinstance(p, ast.Attribute) and p.attr == tgt.attr
                   for p in parts)

    @staticmethod
    def _registry_sized(fn: ast.AST) -> bool:
        for n in ast.walk(fn):
            if isinstance(n, ast.Attribute) and n.attr == "capacity":
                return True
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "reserve":
                return True
        return False

    def check(self, module: Module) -> Iterator[Finding]:
        if module.rel.endswith(("repro/core/rows.py",
                                "repro_torch/core/rows.py")):
            return            # the sanctioned implementations
        for fn, _cls in _functions(module.tree):
            if self._registry_sized(fn):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and self._is_self_concat(node):
                    yield self.finding(
                        module, node,
                        "hand-rolled concatenate growth on an instance "
                        "attribute — use a RowRegistry (core/rows.py) "
                        "or size against its .capacity")


# -- rule 5: host-sync -------------------------------------------------------

class HostSyncRule(Rule):
    """Decision-plane modules must not force host<->device syncs in
    hot paths: `.item()`, `.cpu()`, `.tolist()`, `.numpy()`, and
    `float()/int()/bool()/np.asarray()` applied to torch-valued
    expressions each block on the device.  Legitimate mirror-side syncs
    (the lazy d2h of the residency protocol, scalar decision APIs
    documented to return host floats) carry pragmas citing the residency
    rule."""

    name = "host-sync"
    contract = "docs/training_plane.md residency: zero per-member host " \
               "transfer in batched decision paths"

    _MODULES = ("repro_torch/core/trainer.py",
                "repro_torch/core/transmission.py",
                "repro_torch/core/batching.py", "repro_torch/core/gaimd.py",
                "repro_torch/core/drift.py")
    _SYNCS = ("item", "cpu", "tolist", "numpy")
    _CASTS = {"float", "int", "bool"}
    _TORCH = {"torch"}

    def check(self, module: Module) -> Iterator[Finding]:
        if not module.rel.endswith(self._MODULES):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self._SYNCS and not node.args:
                yield self.finding(
                    module, node,
                    f".{node.func.attr}() forces a device->host sync in a "
                    f"decision-plane module")
                continue
            dotted = _dotted(node.func)
            is_cast = (isinstance(node.func, ast.Name)
                       and node.func.id in self._CASTS)
            is_asarray = dotted in ("np.asarray", "numpy.asarray")
            if (is_cast or is_asarray) and node.args \
                    and _mentions(node.args[0], self._TORCH):
                kind = node.func.id if is_cast else "np.asarray"
                yield self.finding(
                    module, node,
                    f"{kind}() on a torch-valued expression blocks on the "
                    f"device in a decision-plane module — keep the value "
                    f"device-side or pragma the documented sync point")


# -- rule 6: determinism -----------------------------------------------------

class DeterminismRule(Rule):
    """Decision code in core/ and serve/ must be replayable: no
    wall-clock reads (`time.time`), no unseeded module-level
    `np.random.*` draws (use `np.random.default_rng(seed)`), and no
    iteration over `set(...)` feeding decision outputs (set order is
    hash-seed dependent)."""

    name = "determinism"
    contract = "ROADMAP bit-identity bar: decisions replay exactly; " \
               "golden traces pin them"

    _SCOPE = ("repro_torch/core/", "repro_torch/serve/")
    _SEEDED = {"default_rng", "Generator", "SeedSequence", "PCG64",
               "Philox"}

    def check(self, module: Module) -> Iterator[Finding]:
        if not any(s in module.rel for s in self._SCOPE):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted == "time.time":
                    yield self.finding(
                        module, node,
                        "time.time() in decision code — inject a clock "
                        "(time.monotonic default + test fake) instead")
                elif dotted and dotted.startswith(("np.random.",
                                                   "numpy.random.")):
                    leaf = dotted.rsplit(".", 1)[1]
                    if leaf not in self._SEEDED:
                        yield self.finding(
                            module, node,
                            f"unseeded np.random.{leaf}() — draw from "
                            f"np.random.default_rng(seed) so runs replay")
            elif isinstance(node, ast.For):
                it = node.iter
                unordered = (isinstance(it, (ast.Set, ast.SetComp))
                             or (isinstance(it, ast.Call)
                                 and isinstance(it.func, ast.Name)
                                 and it.func.id in ("set", "frozenset")))
                if unordered:
                    yield self.finding(
                        module, node,
                        "iteration over a set feeds decision code — "
                        "sort it (sorted(...)) for a replayable order")


# -- rule 7: profile-resolution ----------------------------------------------

class ProfileResolutionRule(Rule):
    """ProfileTable literals must be uniform-resolution: every
    `configs` entry's resolution (second element) equals the stream's
    seq_len.  The controller enforces resolution == seq_len at
    construction; statically, a profile literal mixing resolutions is
    always wrong."""

    name = "profile-resolution"
    contract = "docs/transmission_plane.md: resolution == seq_len on " \
               "every ProfileTable row"

    def check(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Dict):
                continue
            for key, val in zip(node.keys, node.values):
                if not (isinstance(key, ast.Constant)
                        and key.value == "configs"):
                    continue
                resolutions: Set[object] = set()
                entries: List[ast.AST] = []
                if isinstance(val, ast.List):
                    entries = val.elts
                elif isinstance(val, ast.ListComp):
                    entries = [val.elt]
                for e in entries:
                    if isinstance(e, (ast.List, ast.Tuple)) \
                            and len(e.elts) >= 2 \
                            and isinstance(e.elts[1], ast.Constant):
                        resolutions.add(e.elts[1].value)
                if len(resolutions) > 1:
                    yield self.finding(
                        module, val,
                        f"profile literal mixes resolutions "
                        f"{sorted(resolutions)} — resolution must equal "
                        f"seq_len on every configs row")


# -- rule 8: pragma-reason ---------------------------------------------------

class PragmaReasonRule(Rule):
    """Every `# fleetlint: disable=` pragma must carry a justification
    (`-- why this side of the contract makes it legal`) and must name a
    real rule — a typo'd rule name silently disables nothing."""

    name = "pragma-reason"
    contract = "docs/static_analysis.md pragma policy: suppressions " \
               "document their contract citation"

    def __init__(self, known_rules: Sequence[str] = ()):
        self.known = set(known_rules) | {"*", self.name} | REFERENCE_ONLY

    def check(self, module: Module) -> Iterator[Finding]:
        for p in module.pragmas:
            if not p.reason:
                yield Finding(self.name, module.path, p.line, 0,
                              "pragma without a justification — add "
                              "'-- <why the contract allows this>'")
            unknown = [r for r in p.rules if r not in self.known]
            if unknown and self.known - {"*", self.name}:
                yield Finding(self.name, module.path, p.line, 0,
                              f"pragma names unknown rule(s) "
                              f"{unknown} — typo'd suppressions disable "
                              f"nothing")


# the JAX package's rules the port does not carry (module docstring)
REFERENCE_ONLY = frozenset({"mesh-compat"})


def default_rules() -> List[Rule]:
    """The shipped rule set (7 contract rules + the pragma meta rule)."""
    rules: List[Rule] = [
        BorrowedStackRule(),
        SyncBeforeCaptureRule(),
        PerMemberLoopRule(),
        RowsDisciplineRule(),
        HostSyncRule(),
        DeterminismRule(),
        ProfileResolutionRule(),
    ]
    rules.append(PragmaReasonRule([r.name for r in rules]))
    return rules
