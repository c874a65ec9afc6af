"""Restore across topologies (port of ``t2omca_tpu/utils/elastic.py``).

A checkpoint holds the global state whatever topology wrote it (a
data-parallel run's rank 0 writes the gathered state in the one-card
layout, ``utils/checkpoint.py``), so a change of rank or device count is
placement alone: the reading run keeps its own part of each leaf. A
change of the population's size (P → P′, or a population ↔ a classic
run) is the one change of the state itself: it is reshaped
(``checkpoint.restore_elastic``). This module is the driver's resume
router (the driver builds the current run's stamp, the dict
``save_checkpoint`` writes into ``meta.json``):

* :func:`topology_mismatch`: the readable differences between a saved
  stamp and the current one on JAX's compared keys (empty when they agree
  or the checkpoint has no stamp);
* :func:`resume_state`: a population resize or flip routes through the
  elastic restore; a device, process or loop change is logged as
  placement and takes the rigid path; a checkpoint without a stamp that
  fails the rigid path gets one elastic retry.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

from . import checkpoint as _ckpt

logger = logging.getLogger(__name__)

#: stamp keys compared (JAX's); the rest of the stamp is informational
_COMPARED_KEYS = ("population", "device_count", "process_count", "loop")


def topology_mismatch(saved: Optional[dict], current: dict) -> List[str]:
    """The differences on the compared keys present in both stamps."""
    if not saved:
        return []
    return [f"{k}: saved {saved[k]!r} -> current {current[k]!r}"
            for k in _COMPARED_KEYS
            if k in saved and k in current and saved[k] != current[k]]


def _needs_elastic(saved: Optional[dict], current: dict) -> bool:
    """Whether the stored state itself must be reshaped: a population of
    another size, or a population ↔ a classic run."""
    if not saved or "population" not in saved:
        return False
    return saved["population"] != current.get("population")


def resume_state(dirname: str, template: Any, verify: bool = True,
                 topology: Optional[dict] = None, place=None,
                 prng_impl: Optional[str] = None) -> Any:
    """Restore ``dirname`` into the current topology: ``template`` is this
    run's (or this rank's) state, ``topology`` the driver's stamp facts,
    ``place`` a data-parallel rank's part of each leaf. A stamped
    population mismatch goes through ``checkpoint.restore_elastic`` (a
    shrink keeps the stamped ``member_ranking``'s best); a change of device,
    process or loop shape is logged and handled by placement; a
    checkpoint without a stamp that fails the rigid path structurally is
    retried once through the elastic path. ``prng_impl``: the run's,
    for the rollout keys a lift or a grow re-salts."""
    saved = (_ckpt.read_meta(dirname) or {}).get("topology")
    current = _ckpt._topology_stamp(template, topology)
    diffs = topology_mismatch(saved, current)
    if _needs_elastic(saved, current):
        logger.warning("resume_state: topology changed since %s was "
                       "written (%s) — routing through restore_elastic",
                       dirname, "; ".join(diffs))
        return _ckpt.restore_elastic(dirname, template, verify=verify,
                                     prng_impl=prng_impl)
    if diffs:
        logger.warning("resume_state: placement-only topology change for "
                       "%s (%s) — each leaf is placed onto the current "
                       "run", dirname, "; ".join(diffs))
    try:
        return _ckpt.load_checkpoint(dirname, template, verify=verify,
                                     place=place, prng_impl=prng_impl)
    except ValueError as e:
        if saved is not None:
            raise             # stamped and the same shape: a real config
            #                   mismatch, not elasticity
        logger.warning("resume_state: rigid restore of stampless "
                       "checkpoint %s failed structurally (%s) — retrying "
                       "through restore_elastic once", dirname, e)
        return _ckpt.restore_elastic(dirname, template, verify=verify,
                                     prng_impl=prng_impl)
