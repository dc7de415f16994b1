"""V-trace off-policy correction (IMPALA), port of ray_tpu/rllib/vtrace.py.

The importance-weighted value targets and policy-gradient advantages of
Espeholt et al. 2018, as one reverse loop over the time-major fragment.
The reference takes `stop_gradient` of both outputs; here they are
computed under `no_grad`, so no graph is built and nothing flows back
through them whatever the inputs require.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor             # [T, B] value targets
    pg_advantages: torch.Tensor  # [T, B]


@torch.no_grad()
def vtrace(behavior_logp: torch.Tensor, target_logp: torch.Tensor,
           rewards: torch.Tensor, discounts: torch.Tensor,
           values: torch.Tensor, bootstrap_value: torch.Tensor,
           clip_rho_threshold: float = 1.0,
           clip_c_threshold: float = 1.0) -> VTraceReturns:
    """All args time-major [T, B]; bootstrap_value [B].

    discounts must already include termination masking
    (gamma * (1 - done)).
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=clip_c_threshold)

    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)

    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values

    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_advantages = clipped_rhos * (rewards + discounts * vs_tp1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
