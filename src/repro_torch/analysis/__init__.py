"""repro_torch.analysis -- the port's invariant checks (port of
``repro.analysis``).

The JAX package states its strongest guarantees at the graph level
(``docs/static_analysis.md``): the rank-p solve makes no dimension beyond
p, no device holds a full coordinate width under a mesh, membership churn
never recompiles, bf16 inputs accumulate in fp32, no host transfer
happens in the hot path, collective bytes a device stay O(n + W^2).  This
package checks the port against the same guarantees, read for eager
PyTorch: what a jaxpr or an HLO module shows to JAX, a
``TorchDispatchMode`` record of one call shows to the port on the CPU,
and CUDA's sync-debug mode, ``ptxas -v`` and ``compute-sanitizer`` show on
the card.

* :mod:`repro_torch.analysis.trace` -- :func:`capture`, the record of one
  call (ops, collectives, taint, syncs), and :class:`allowed`, the scope
  that names a finding that stays at its site;
* :mod:`repro_torch.analysis.rules` -- SHAPE, PRECISION, TRANSFER, MASK,
  COLLECTIVES over captured calls;
* :mod:`repro_torch.analysis.recompile` -- RECOMPILE: one captured
  program for every variant;
* :mod:`repro_torch.analysis.kernel_rules` -- the kernel families (site
  counts, KBUDGET from ``ptxas``, KSENTINEL, the sanitizer's verdict);
* :mod:`repro_torch.analysis.contract` -- the ``@contract`` entry-point
  decorator (zero-cost unless ``REPRO_CONTRACTS=1`` /
  :func:`enable_contracts`);
* :mod:`repro_torch.analysis.entrypoints` -- the public-entry-point sweep
  that ``python -m repro_torch.launch.lint`` runs.
"""

from repro_torch.analysis.contract import (checking, contract,
                                           contracts_enabled,
                                           enable_contracts)
from repro_torch.analysis.findings import (ContractViolation, Finding,
                                           Report, format_findings)
from repro_torch.analysis.kernel_rules import (SMEM_LIMIT_BYTES,
                                               KernelBudget,
                                               check_kernel_budget,
                                               check_kernel_sentinel,
                                               check_kernel_sites,
                                               check_sanitizer, parse_ptxas)
from repro_torch.analysis.recompile import (assert_no_recompile,
                                            check_recompile, signatures)
from repro_torch.analysis.rules import (RULES, check_collectives,
                                        check_mask, check_precision,
                                        check_shape, check_transfer,
                                        full_width_dims)
from repro_torch.analysis.trace import Trace, allowed, capture

__all__ = [
    "ContractViolation", "Finding", "KernelBudget", "RULES", "Report",
    "SMEM_LIMIT_BYTES", "Trace", "allowed", "assert_no_recompile",
    "capture", "check_collectives", "check_kernel_budget",
    "check_kernel_sentinel", "check_kernel_sites", "check_mask",
    "check_precision", "check_recompile", "check_sanitizer", "check_shape",
    "check_transfer", "checking", "contract", "contracts_enabled",
    "enable_contracts", "format_findings", "full_width_dims",
    "parse_ptxas", "signatures",
]
