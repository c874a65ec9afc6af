"""The serving program: greedy action selection as one step (port of
``t2omca_tpu/serve/program.py``).

``q = forward(params, obs, hidden)`` masked-argmaxed over ``avail``. In
test mode both selector families reduce to ``masked_argmax`` over the
deterministic forward, so the step drops the key plumbing; with f32
params its actions equal ``BasicMAC.select_actions(test_mode=True)``.
PyTorch runs eagerly, so there is no export: the step runs under
``torch.inference_mode()`` on the MAC's device, inside a
``torch.profiler.record_function("serve_step")`` range, the program
name ``obs/device_time.py`` attributes a trace's device time to.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..components.action_selectors import masked_argmax


def build_serve_step(mac):
    """→ ``serve_step(params, obs, avail, hidden) -> (actions int32,
    hidden')`` for a built ``BasicMAC``. ``params`` may be the raw state
    dict or a ``prepare_acting_params`` result; obs ``(B, A, obs_dim)``,
    avail ``(B, A, n_actions)`` bool/int, hidden ``(B, A, emb)``, all on
    the MAC's device. The forward runs at the train dtype (serving's
    dtype story is the param variant, not ``model.act_dtype``)."""

    def serve_step(params, obs, avail, hidden):
        with torch.inference_mode(), record_function("serve_step"):
            if mac.use_qslice:
                q, hidden = mac.forward_qslice(params, obs, hidden)
            else:
                q, hidden = mac.forward(params, obs, hidden)
            return masked_argmax(q, avail).to(torch.int32), hidden

    return serve_step
