"""GT014: serving-knob mutation outside a guarded apply path.

The online auto-tuner made the engine's serving knobs —
prompt-bucket ladders, fused steps per tick, spec-γ cap, page-reserve
watermark, WFQ class weights, batcher coalescing — *mutable at
runtime*, which is only safe because every mutation funnels through one
guarded, validate-then-swap apply path
(``GenerationEngine.apply_operating_point`` /
``DynamicBatcher.apply_operating_point``): shape-changing moves are
refused until pre-warmed, brownouts refuse any move, and the swap is
atomic with respect to the engine loop. A direct write —
``engine.steps_per_tick = 8`` from a cron handler, a debug endpoint, a
"quick fix" in an example — bypasses all of it: it can push a compile
onto the serving path, tear the knob set mid-tick, and leave the
operating-point provenance lying about what is live. This rule is the
static guard on that funnel.

What it flags: an ``ast.Assign`` / ``ast.AugAssign`` whose target is
``<receiver>.<knob>`` (or a subscript of one, e.g.
``engine.class_weights["batch"] = 9``) where

- ``<knob>`` is one of the serving-knob attribute names below,
- the receiver is NOT ``self`` (a class managing its own state inside
  its own methods is the implementation, not a bypass), and
- the enclosing function is not itself a sanctioned apply path
  (``apply_operating_point``, ``set_weights``) or a constructor
  (``__init__`` wires the seed point).

Knob set: ``steps_per_tick``, ``prompt_buckets``, ``spec_gamma``,
``max_slots``, ``slots_cap``, ``class_weights``, ``staging_depth``,
``max_batch``, ``max_delay``, ``max_delay_ms``, ``kv_page_reserve``,
``_gamma_cap``, ``_kv_reserve``, ``_k_ladder``.

What clears it: route the change through the owning object's
``apply_operating_point`` (engine or batcher), or
``ClassQueues.set_weights`` for admission weights. Tests that
deliberately poke internals suppress per line with
``# graftcheck: ignore[GT014]``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

# Runtime-tunable serving knobs: the attribute names the guarded apply
# paths own. Includes the engine's private derived state (_gamma_cap /
# _kv_reserve / _k_ladder) — writing those from outside is the same
# bypass with one more underscore.
KNOB_ATTRS = frozenset({
    "steps_per_tick", "prompt_buckets", "spec_gamma", "max_slots",
    "slots_cap", "class_weights", "staging_depth",
    "max_batch", "max_delay", "max_delay_ms", "kv_page_reserve",
    "_gamma_cap", "_kv_reserve", "_k_ladder",
})

# Functions allowed to write knobs directly: the guarded apply paths
# themselves, and constructors (the seed operating point is wired
# there).
SANCTIONED_FUNCTIONS = frozenset({
    "apply_operating_point", "set_weights", "__init__",
})


def _assign_targets(node: ast.AST) -> List[ast.expr]:
    if isinstance(node, ast.Assign):
        out: List[ast.expr] = []
        for target in node.targets:
            if isinstance(target, ast.Tuple):
                out.extend(target.elts)
            else:
                out.append(target)
        return out
    if isinstance(node, ast.AugAssign):
        return [node.target]
    return []


class ServingKnobMutationRule(Rule):
    rule_id = "GT014"
    title = "serving-knob-mutation"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            for target in _assign_targets(node):
                # peel a subscript: engine.class_weights["batch"] = ...
                # mutates the knob exactly like a whole-value write
                attr = (target.value
                        if isinstance(target, ast.Subscript) else target)
                if not isinstance(attr, ast.Attribute):
                    continue
                if attr.attr not in KNOB_ATTRS:
                    continue
                receiver = attr.value
                if isinstance(receiver, ast.Name) and \
                        receiver.id == "self":
                    continue
                fn = module.enclosing_function(node)
                if fn is not None and fn.name in SANCTIONED_FUNCTIONS:
                    continue
                recv = module.dotted(receiver) or "<expr>"
                findings.append(Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=node.lineno,
                    message=(
                        f"direct write to serving knob "
                        f"'{recv}.{attr.attr}' bypasses the guarded "
                        f"apply path — route it through "
                        f"apply_operating_point() (pre-warm, brownout "
                        f"refusal, atomic swap) so a knob move can "
                        f"never compile on the serving path or tear "
                        f"mid-tick"),
                    severity=self.severity,
                    key=f"knob write {recv}.{attr.attr}",
                ))
        findings.sort(key=lambda f: f.line)
        return findings
