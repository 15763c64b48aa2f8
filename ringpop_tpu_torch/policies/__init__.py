"""Remediation policy plane: operator actions riding the scenario runner.

The port of ``ringpop_tpu/policies``: admission control (load shedding
at hot holders), adaptive retry budgets keyed on observed amplification,
and serve-side quarantine that steers rings away from pressured nodes
before suspicion fires, next to the overload feedback loop.  One
int-exact per-tick update (``core.policy_update``) serves the scenario
runner (torch tensors) and a host oracle (numpy arrays) alike.
"""

from ringpop_tpu_torch.policies.core import (  # noqa: F401
    INF,
    CompiledPolicy,
    PolicyConfig,
    PolicyKnobs,
    POLICIES,
    compile_policy,
    format_catalog,
    from_dict,
    init_policy_state,
    knob_arrays,
    list_policies,
    parse_policy_arg,
    policy_update,
    to_dict,
)
