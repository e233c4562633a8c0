"""tpu_hpc_torch.loadgen -- the SLO-driven load harness (port of the JAX
package's ``tpu_hpc.loadgen``).

Seeded, scenario-diverse traffic for the serve engine (scenarios.py)
driven on a virtual clock so latency quantiles replay bit-identically
(harness.py), every request lifecycle emitted as schema-stamped
``obs`` records -- the JSONL the regression gate
(``python -m tpu_hpc_torch.obs.regress``) and the trace analyzer
(``python -m tpu_hpc_torch.obs.trace``) read.
"""
from tpu_hpc_torch.loadgen.harness import (  # noqa: F401
    ENV_FAULTS,
    FAULT_DEFAULTS,
    FLEET_FAULT_KEYS,
    LoadHarness,
    LoadMeter,
    VirtualClock,
    fleet_faults_set,
    parse_faults,
    tenant_summary,
)
from tpu_hpc_torch.loadgen.scenarios import (  # noqa: F401
    SCENARIOS,
    SLO_METRICS,
    LoadRequest,
    Scenario,
    TenantClass,
    build_scenario,
)

__all__ = [
    "ENV_FAULTS",
    "FAULT_DEFAULTS",
    "FLEET_FAULT_KEYS",
    "LoadHarness",
    "LoadMeter",
    "LoadRequest",
    "SCENARIOS",
    "SLO_METRICS",
    "Scenario",
    "TenantClass",
    "VirtualClock",
    "build_scenario",
    "fleet_faults_set",
    "parse_faults",
    "tenant_summary",
]
