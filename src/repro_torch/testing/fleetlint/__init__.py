"""fleetlint for the port: contract-enforcing static analysis + runtime
sanitizer for the five planes (docs/static_analysis.md), the JAX
package's linter with its rules scoped to `repro_torch/`.

    python -m repro_torch.testing.fleetlint src/repro_torch
"""
from repro_torch.testing.fleetlint.engine import (Finding, Module, Pragma,
                                                  Rule, check_module,
                                                  load_module,
                                                  module_from_source, run)
from repro_torch.testing.fleetlint.rules import default_rules

__all__ = ["Finding", "Module", "Pragma", "Rule", "check_module",
           "load_module", "module_from_source", "run", "default_rules"]
